"""Weight loading in the port: the safetensors reader and writer
(ttt_video_dit_torch/utils/safetensors.py) against the ``safetensors``
package; the HF CogVideoX key map (models/dit/from_hf.py) against the JAX
package's ``map_hf_tensor`` followed by ``convert.flax_to_state_dict``, bit
for bit, with the same names taken; the params-only checkpoint
(training/checkpoint.py) round trip, bit for bit; and a tiny DiT loaded that
way against the JAX model on the same params, at tests/test_torch_model.py's
tolerance (|port - flax| <= 1e-5 max|flax| + 1e-5 |flax|).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("safetensors")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from safetensors.torch import load_file as st_load, save_file as st_save  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit import from_hf  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.training.checkpoint import load_pretrained, save_pretrained  # noqa: E402
from ttt_video_dit_torch.utils import safetensors  # noqa: E402
from ttt_video_dit_tpu.models.dit import from_hf as j_from_hf  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from tests.test_torch_model import _close, _random_params  # noqa: E402

torch.set_num_threads(1)
CFG = __graft_entry__._flagship_config(tiny=True)
LAT, TEXT_LEN = 8, 16


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w32": torch.randn(3, 5, generator=g), "w16": torch.randn(7, generator=g).half(),
            "wbf": torch.randn(2, 3, 4, generator=g).bfloat16(), "i64": torch.randint(-9, 9, (6,), generator=g),
            "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4)}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_reader_and_writer_match_the_safetensors_package(tmp_path):
    """Every dtype (F32, F16, BF16, I64), a scalar and an empty tensor, both ways."""
    want = _tensors()
    st_save(want, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    got = safetensors.load_file(str(tmp_path / "pkg.safetensors"))
    assert got.keys() == want.keys() and all(_same(got[k], want[k]) for k in want)
    safetensors.save_file(want, str(tmp_path / "ours.safetensors"))
    back = st_load(str(tmp_path / "ours.safetensors"))
    assert back.keys() == want.keys() and all(_same(back[k], want[k]) for k in want)


@pytest.mark.parametrize("index", [True, False], ids=["index_json", "no_index"])
def test_reader_streams_a_shard_directory(tmp_path, index):
    """Shards listed by ``*.safetensors.index.json`` (which may name them in
    any order) or found by name; one tensor yielded at a time."""
    a, b = _tensors(1), {f"x.{i}": torch.full((2,), float(i)) for i in range(3)}
    st_save(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    st_save(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    if index:
        weight_map = {**{k: "model-00002-of-00002.safetensors" for k in b},
                      **{k: "model-00001-of-00002.safetensors" for k in a}}
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": weight_map}))
        (tmp_path / "stray.safetensors").write_bytes(b"not listed")  # not in the index: never opened
    items = safetensors.iter_tensors(str(tmp_path))
    assert not isinstance(items, (list, dict))
    got = dict(items)
    want = {**a, **b}
    assert got.keys() == want.keys() and all(_same(got[k], want[k]) for k in want)


def test_reader_refuses_what_it_cannot_read(tmp_path):
    st_save({"i32": torch.zeros(3, dtype=torch.int32)}, str(tmp_path / "i32.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        safetensors.load_file(str(tmp_path / "i32.safetensors"))
    st_save({"w": torch.zeros(64)}, str(tmp_path / "cut.safetensors"))
    data = (tmp_path / "cut.safetensors").read_bytes()
    (tmp_path / "cut.safetensors").write_bytes(data[:-8])
    with pytest.raises(ValueError, match="past the end"):
        safetensors.load_file(str(tmp_path / "cut.safetensors"))
    with pytest.raises(FileNotFoundError):
        safetensors.load_file(str(tmp_path / "nothing_here"))


def _hf_names(cfg):
    """Diffusers CogVideoX names for the tiny model (every name the map takes,
    with the shapes of the port's parameters), plus names it does not take."""
    port = TorchCogVideoX(cfg).state_dict()
    names = list(from_hf._TOP) + [f"transformer_blocks.{i}.{n}.{leaf}" for i in range(cfg.num_layers)
                                  for n in from_hf._BLOCK for leaf in ("weight", "bias")]
    shapes = {}
    for n in names:
        key = from_hf.hf_key(n)
        if key in port:  # LayerNorms of q/k have biases, every norm has one
            shapes[n] = tuple(port[key].shape)
    shapes.update({"patch_embed.pos_embedding": (1, 4, 8), "transformer_blocks.0.attn1.norm_cross.weight": (4,),
                   "transformer_blocks.1.ff.net.1.weight": (3,)})
    return shapes


def _fabricate_hf(tmp_path, cfg, seed=0):
    """bf16 HF-named shards (two files and an index) from a seed."""
    g = torch.Generator().manual_seed(seed)
    tensors = {n: (torch.randn(s, generator=g) * 0.05).bfloat16() for n, s in _hf_names(cfg).items()}
    names = sorted(tensors)
    half = len(names) // 2
    d = tmp_path / "hf"
    d.mkdir()
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": names[:half],
              "diffusion_pytorch_model-00002-of-00002.safetensors": names[half:]}
    for fn, keys in shards.items():
        st_save({k: tensors[k] for k in keys}, str(d / fn))
    weight_map = {k: fn for fn, keys in shards.items() for k in keys}
    (d / "diffusion_pytorch_model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return d, tensors


def test_map_matches_the_jax_map_bit_for_bit(tmp_path):
    """Each fabricated name through both maps: the same names taken, and the
    port's tensor equal to the JAX map's array carried by flax_to_state_dict."""
    _, tensors = _fabricate_hf(tmp_path, CFG)
    tree, port = {}, {}
    for name, t in tensors.items():
        j = j_from_hf.map_hf_tensor(name, t.float().numpy())
        p = from_hf.map_hf_tensor(name, t)
        assert (j is None) == (p is None), name
        if j is not None:
            j_from_hf._set(tree, j[0], j[1])
            port[p[0]] = p[1].float()
    assert len(port) == len(tensors) - 3
    want = convert.flax_to_state_dict(tree)
    assert port.keys() == want.keys()
    for k in want:
        assert port[k].dtype == torch.float32 and torch.equal(port[k], want[k]), k


@pytest.fixture(scope="module")
def jax_model():
    model = CogVideoX(CFG)
    vid = jnp.zeros((1, 37, CFG.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, 3, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds), 5)
    return model, jax.tree.map(np.asarray, params)


def test_converted_checkpoint_round_trips_and_matches_jax(tmp_path, rng, jax_model):
    """HF shards overlaid on the same random params by both packages' converters
    (the TTT parameters keep them) give the same state dict bit for bit;
    save_pretrained / load_pretrained gives it back bit for bit; the DiT so
    loaded matches the JAX model on the overlaid params."""
    model, params = jax_model
    hf_dir, _ = _fabricate_hf(tmp_path, CFG, seed=1)
    j_params, j_mapped = j_from_hf.convert_hf_checkpoint(str(hf_dir), params)
    port = convert.load_flax_params(TorchCogVideoX(CFG), params)
    n_mapped = from_hf.convert_hf_checkpoint(str(hf_dir), port)
    assert n_mapped == j_mapped == len(_hf_names(CFG)) - 3
    want = convert.flax_to_state_dict(j_params)
    got = port.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    ttt = "dit.layers.0.seq_modeling_block.ssm.W1"
    assert torch.equal(got[ttt], convert.flax_to_state_dict(params)[ttt])  # kept its init

    path = save_pretrained(str(tmp_path / "ckpt"), port)
    assert path.endswith("model.safetensors")
    loaded = load_pretrained(str(tmp_path / "ckpt"), TorchCogVideoX(CFG)).eval()
    back = loaded.state_dict()
    assert back.keys() == got.keys() and all(_same(back[k], got[k]) for k in got)

    vid = rng.standard_normal((2, 37, CFG.in_channels, LAT, LAT)).astype(np.float32)
    text = rng.standard_normal((2, 3, TEXT_LEN, CFG.text_dim)).astype(np.float32)
    a, t = np.array([0.3, 0.9], np.float32), np.array([700.0, 40.0], np.float32)
    want_out = jax.jit(lambda p, *x: model.apply(p, *x, method="denoise"))(
        jax.tree.map(jnp.asarray, j_params), *(jnp.asarray(x) for x in (vid, a, text, t)))
    with torch.inference_mode():
        got_out = loaded.denoise(*(torch.from_numpy(x) for x in (vid, a, text, t)))
    _close(got_out, want_out)


def test_load_pretrained_is_strict(tmp_path):
    cfg = dataclasses.replace(CFG, num_layers=1)
    model = TorchCogVideoX(cfg)
    sd = model.state_dict()
    safetensors.save_file({k: v for k, v in sd.items() if "final_layer" not in k}, str(tmp_path / "missing.safetensors"))
    with pytest.raises(KeyError, match="missing"):
        load_pretrained(str(tmp_path / "missing.safetensors"), model)
    safetensors.save_file({**sd, "dit.extra": torch.zeros(1)}, str(tmp_path / "extra.safetensors"))
    with pytest.raises(KeyError, match="dit.extra"):
        load_pretrained(str(tmp_path / "extra.safetensors"), model)
    safetensors.save_file({**sd, "dit.time_embed_0.bias": torch.zeros(3)}, str(tmp_path / "shape.safetensors"))
    with pytest.raises(ValueError, match="time_embed_0"):
        load_pretrained(str(tmp_path / "shape.safetensors"), model)


def test_load_into_renames_skips_and_counts(tmp_path):
    """The one loader under load_pretrained, T5 and from_hf: ``rename`` maps or
    skips (None) each name, a kept name must be the module's, and ``strict``
    alone decides whether entries left unloaded are an error."""
    module = torch.nn.Linear(3, 2)
    src = {"w": torch.randn(2, 3).bfloat16(), "b": torch.randn(2), "skip": torch.zeros(1)}
    safetensors.save_file(src, str(tmp_path / "m.safetensors"))
    rename = {"w": "weight", "b": "bias"}.get
    assert safetensors.load_into(module, str(tmp_path / "m.safetensors"), rename) == 2
    assert module.weight.dtype == torch.float32 and torch.equal(module.weight, src["w"].float())
    assert torch.equal(module.bias, src["b"])
    assert safetensors.load_into(module, [("b", torch.ones(2))], rename, strict=False) == 1
    assert torch.equal(module.bias, torch.ones(2))
    with pytest.raises(KeyError, match="missing 1 keys"):
        safetensors.load_into(module, [("b", torch.ones(2))], rename)
    with pytest.raises(KeyError, match="'skip' \\(as 'other'\\)"):
        safetensors.load_into(module, [("skip", torch.ones(1))], lambda k: "other")


@pytest.mark.parametrize("ssm_flag", [None, "ttt_mlp"])
def test_from_hf_cli_writes_an_init_state_dir(tmp_path, monkeypatch, ssm_flag):
    """The CLI on the sampling entry's flags (the ttt-linear eval TOML, cut to
    the tiny widths): its directory holds the HF tensors and the TTT init of
    --job.seed, for the TOML's TTT variant, or for --ssm-layer's where given."""
    from pathlib import Path

    monkeypatch.chdir(Path(__file__).resolve().parent.parent)
    flags = ["--job.config_file", "configs/eval/ttt-linear/3s.toml", "--model.num_layers", "2", "--model.model_dim",
             "128", "--model.num_heads", "8", "--job.seed", "3"]
    from ttt_video_dit_torch.sample import model_config, parse_args

    cfg = model_config(parse_args(flags))
    assert cfg.ssm_layer == "ttt_linear"
    if ssm_flag:
        cfg.ssm_layer = ssm_flag
    hf_dir, tensors = _fabricate_hf(tmp_path, cfg, seed=2)
    out = tmp_path / "init"
    n = from_hf.main(["--hf-dir", str(hf_dir), "--output", str(out), *flags]
                     + (["--ssm-layer", ssm_flag] if ssm_flag else []))
    assert n == len(tensors) - 3
    sd = safetensors.load_file(str(out / "model.safetensors"))
    want, _ = from_hf.converted_model(str(hf_dir), cfg, seed=3)
    assert sd.keys() == want.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in want.state_dict().items())
    assert torch.equal(sd["dit.layers.1.mlp.layer2.weight"], tensors["transformer_blocks.1.ff.net.2.weight"].float())
    assert ("dit.layers.0.seq_modeling_block.ssm.W2" in sd) == (cfg.ssm_layer == "ttt_mlp")  # TTT-MLP's state
