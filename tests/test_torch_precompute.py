"""The port's offline tools (ttt_video_dit_torch/data/precompute_{text,video}.py)
against the JAX package's (data/precompute_{text,video}.py at the repo root)
on the CPU.

- Text: both ``main``s on a tiny T5 directory (a Unigram tokenizer.json
  and ``T5EncoderModel.save_pretrained``, d_model 32, as
  tests/test_torch_t5.py builds it), 5 annotations in batches of 2 at
  max length 8. They write the same files in the four token modes, within
  the T5 tolerance of tests/test_torch_t5.py (relative L2 1e-5, 1e-5 +
  1e-5 |ref| elementwise). The scene tokens' fresh rows are the port's,
  copied into the JAX tool's encoder. The port runs with ``transformers``,
  ``tokenizers``, ``sentencepiece`` and ``google.protobuf`` blocked, under
  every ``--t5-backend`` value.
- Video: the per-episode function on the tiny VAE (ch 32, ch_mult (1, 2))
  and tests/test_torch_vae.py's 4-level one against the JAX VAE's
  ``encode_first_stage(unregularized=True)`` on the same parameters, 49
  frames (one window of 48 + 1), within 1e-4. Also
  checked: the 48n+1 refusal's text; the dealing of episodes over
  ``--process-index``/``--process-count`` (and their environment
  defaults); ``validate_existing``; skipping a valid output and redoing an
  invalid one; the ImportError naming ``imageio``; and ``--spatial-shard``
  under torchrun at world 2.

Both ``main``s run end to end with the mp4 reader replaced by frames held in
memory, since imageio has no ffmpeg backend here. Run under torchrun, this
file is the ``--spatial-shard`` worker: ``precompute_video.main`` with each
``<episode>.mp4`` read from the ``<episode>.npy`` beside it::

    python -m torch.distributed.run --standalone --nproc_per_node 2 tests/test_torch_precompute.py <main's flags>
"""

import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch.data import precompute_text as t_text  # noqa: E402
from ttt_video_dit_torch.data import precompute_video as t_video  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("transformers", "tokenizers", "sentencepiece", "google.protobuf")
TEXTS = ["the cat sat on the mat", "a dog ran", "dog", "the mat the cat sat on the mat", "a cat ran on the mat"]
# A VAE whose posterior has the published geometry, [T/4 + 1, 32, 60, 90] at 480 x 720, at small widths.
SHARD_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, z_channels=16, resolution=32, dropout=0.0)


def _jax_tool(name):
    """data/<name>.py at the repo root, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "data" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*.npy"))


# ----------------------------------------------------------------- text
@pytest.fixture(scope="module")
def text_run(tmp_path_factory):
    """The tiny T5 directory, the annotations, and the JAX tool's output."""
    pytest.importorskip("transformers")
    from tests.test_torch_t5 import WORDS, _make_tiny_t5_dir
    from ttt_video_dit_tpu.models import t5 as j_t5

    root = tmp_path_factory.mktemp("precompute_text")
    t5_dir = _make_tiny_t5_dir(root, "gated-gelu")
    jsonl = root / "ann.jsonl"
    jsonl.write_text("".join(json.dumps({"text": t, "name": f"clip{i}"}) + "\n" for i, t in enumerate(TEXTS)))
    rows = torch.randn(2, 32, generator=torch.Generator().manual_seed(0))  # the port's scene rows (seed 0)
    init = j_t5.T5TextEncoder.__init__

    def with_port_rows(self, *args, **kwargs):
        init(self, *args, **kwargs)
        assert self.encoder.shared.weight.shape[0] == len(WORDS) + 2
        with torch.no_grad():
            self.encoder.shared.weight[-2:] = rows

    flags = ["--t5-dir", str(t5_dir), "--input-jsonl", str(jsonl), "--max-length", "8", "--video-length", "3",
             "--batch-size", "2"]
    argv = sys.argv
    j_t5.T5TextEncoder.__init__ = with_port_rows
    try:
        sys.argv = ["precompute_text.py", *flags, "--output-path", str(root / "jax")]
        _jax_tool("precompute_text").main()
    finally:
        sys.argv = argv
        j_t5.T5TextEncoder.__init__ = init
    return root, flags


@pytest.mark.parametrize("backend", ["auto", "flax", "torch"])
def test_precompute_text_matches_the_jax_tool(text_run, monkeypatch, backend):
    root, flags = text_run
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    out = root / f"port_{backend}"
    summary = t_text.main([*flags, "--output-path", str(out), "--t5-backend", backend, "--device", "cpu"])
    want = _files(root / "jax")
    assert _files(out) == want and len(want) == 4 * len(TEXTS) and summary["files"] == len(want)
    assert sorted(os.listdir(out)) == ["3s-8", "3s-8-both", "3s-8-end", "3s-8-start"]
    for name in want:
        got, ref = np.load(out / name), np.load(root / "jax" / name)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (8, 32)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5, name
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg=name)
    # the scene tokens change what the modes encode
    a, b = (np.load(out / d / "clip1_txt_emb.npy") for d in ("3s-8", "3s-8-both"))
    assert not np.allclose(a, b)


def test_token_modes_match_the_jax_tool():
    from ttt_video_dit_tpu.models.dit.sampler import SCENE_END_TOKEN, SCENE_START_TOKEN

    jax_tool = _jax_tool("precompute_text")
    assert t_text.TOKEN_MODES == jax_tool.TOKEN_MODES
    for mode in t_text.TOKEN_MODES:
        assert t_text.apply_token_mode("a cat", mode) == jax_tool.apply_token_mode("a cat", mode)
    assert t_text.apply_token_mode("x", "both") == f"{SCENE_START_TOKEN}x{SCENE_END_TOKEN}"


@pytest.mark.parametrize("tool", ["precompute_text", "precompute_video"])
def test_tools_need_a_gpu_unless_cpu_is_asked_for(tmp_path, tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only behaviour")
    args = {"precompute_text": ["--t5-dir", "x", "--input-jsonl", "x", "--output-path", str(tmp_path)],
            "precompute_video": ["--episode-dir", "x", "--save-dir", str(tmp_path), "--vae-checkpoint", "x"]}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device available; pass --device cpu"):
        {"precompute_text": t_text, "precompute_video": t_video}[tool].main(args)


# ----------------------------------------------------------------- video
@pytest.mark.parametrize("config,latent", [("tiny", (25, 8, 16, 16)), ("four_levels", (13, 8, 4, 4))])
def test_episode_posterior_matches_the_jax_vae(tmp_path, config, latent):
    """The tiny config compresses time 2x and space 2x, the 4-level one 4x and 8x."""
    from tests.test_torch_vae import CONFIGS, _jax_vae, _port_vae

    jvae = _jax_vae(CONFIGS[config], seed=11)
    vae = _port_vae(jvae, CONFIGS[config])
    frames = np.random.default_rng(3).integers(0, 256, (49, 32, 32, 3), dtype=np.uint8)
    x = (frames.astype(np.float32) / 255.0 * 2.0 - 1.0).transpose(3, 0, 1, 2)[None]
    want = np.asarray(jvae.encode_first_stage(x, unregularized=True))[0].transpose(1, 0, 2, 3)
    path = tmp_path / "ep.npy"
    got = t_video.precompute_episode(vae, str(path), latent[0], lambda: frames)
    assert got.shape == want.shape == latent and got.dtype == np.float32
    np.testing.assert_array_equal(np.load(path), got)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_48n_plus_1_refusal_matches_the_jax_tool(tmp_path, monkeypatch, capsys):
    flags = ["--episode-dir", str(tmp_path), "--save-dir", str(tmp_path), "--vae-checkpoint", "x",
             "--num-frames", "50"]
    with pytest.raises(SystemExit):
        t_video.parse_args(flags)
    got = capsys.readouterr().err.splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["precompute_video.py", *flags])
    with pytest.raises(SystemExit):
        _jax_tool("precompute_video").main()
    want = capsys.readouterr().err.splitlines()[-1]
    message = "--num-frames 50 is not 48n+1; episodes must have fps*seconds+1 frames (e.g. 193 for 12 s at 16 fps)"
    assert got.split("error: ")[1] == want.split("error: ")[1] == message


class _ZeroVAE:
    """Stands in for either package's VAE where only the dealing and skipping
    are under test: a zero posterior [1, 32, T/4 + 1, 60, 90] (within
    validate_existing's ranges)."""

    device = torch.device("cpu")
    encoder = SimpleNamespace(spatial_factor=8, conv_out=SimpleNamespace(conv=SimpleNamespace(out_channels=32)))

    def encode_first_stage(self, x, unregularized=True):
        shape = (1, 32, (x.shape[2] - 1) // 4 + 1, x.shape[3] // 8, x.shape[4] // 8)
        return torch.zeros(shape) if isinstance(x, torch.Tensor) else np.zeros(shape, np.float32)


def _episodes(root, n=7):
    eps = root / "episodes"
    eps.mkdir()
    for i in range(n):
        (eps / f"ep{i}.mp4").write_bytes(b"")
    return eps


def _run_tools(monkeypatch, eps, out, flags, env=None):
    """Both tools' mains with one-frame episodes read from memory and a zero
    VAE: the files each writes, and the episodes each read."""
    from ttt_video_dit_tpu.models.vae import autoencoder as j_ae
    from ttt_video_dit_torch.models.vae import autoencoder as t_ae

    for key, value in (env or {}).items():
        monkeypatch.setenv(key, value)
    read = {"jax": [], "port": []}
    argv = ["--episode-dir", str(eps), "--vae-checkpoint", "x", "--num-frames", "1", *flags]
    for name, ae in (("jax", j_ae), ("port", t_ae)):
        monkeypatch.setattr(ae.VideoAutoencoder, "from_torch_checkpoint", classmethod(lambda cls, *a, **k: _ZeroVAE()))
        tool = _jax_tool("precompute_video") if name == "jax" else t_video
        monkeypatch.setattr(tool, "read_video_frames", lambda path, fps, n, who=name: read[who].append(
            os.path.basename(path)) or np.zeros((n, 480, 720, 3), np.uint8))
        save = ["--save-dir", str(out / name), *(["--device", "cpu"] if name == "port" else [])]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["precompute_video.py", *argv, *save])
            tool.main()
        else:
            tool.main([*argv, *save])
    return {k: _files(out / k) if (out / k).exists() else [] for k in read}, read


@pytest.mark.parametrize("index,count,env", [(0, 3, None), (2, 3, None), (1, 2, None), (None, None, "1/4")])
def test_episodes_dealt_as_the_jax_tool_deals_them(tmp_path, monkeypatch, index, count, env):
    eps = _episodes(tmp_path)
    flags = [] if index is None else ["--process-index", str(index), "--process-count", str(count)]
    environ = None if env is None else dict(zip(("TTT_PROC_ID", "TTT_NUM_PROCS"), env.split("/")))
    files, read = _run_tools(monkeypatch, eps, tmp_path, flags, environ)
    index, count = (index, count) if env is None else map(int, env.split("/"))
    want = [f"ep{i}.npy" for i in range(7)][index::count]
    assert files["port"] == files["jax"] == want
    assert read["port"] == read["jax"] == [f.replace(".npy", ".mp4") for f in want]


def test_valid_outputs_are_skipped_and_invalid_ones_redone(tmp_path, monkeypatch):
    eps = _episodes(tmp_path, n=3)
    _run_tools(monkeypatch, eps, tmp_path, [])
    for name in ("jax", "port"):  # episode 1's output made invalid in both trees
        np.save(tmp_path / name / "ep1.npy", np.full((1, 32, 60, 90), 50.0, np.float32))
    files, read = _run_tools(monkeypatch, eps, tmp_path, [])
    assert read["port"] == read["jax"] == ["ep1.mp4"]
    assert files["port"] == files["jax"] == ["ep0.npy", "ep1.npy", "ep2.npy"]
    assert not np.load(tmp_path / "port" / "ep1.npy").any()


def _posterior(shape=(13, 32, 60, 90), mean=0.0, logvar=-5.0):
    out = np.zeros(shape, np.float32)
    out[:, :16], out[:, 16:] = mean, logvar
    return out


@pytest.mark.parametrize("case", ["valid", "wrong_frames", "wrong_width", "mean_high", "mean_low", "logvar_high",
                                  "logvar_low", "corrupt"])
def test_validate_existing_matches_the_jax_tool(tmp_path, case):
    path = tmp_path / "p.npy"
    arrays = {"valid": _posterior(), "wrong_frames": _posterior((12, 32, 60, 90)),
              "wrong_width": _posterior((13, 32, 60, 45)), "mean_high": _posterior(mean=10.0),
              "mean_low": _posterior(mean=-10.5), "logvar_high": _posterior(logvar=10.0),
              "logvar_low": _posterior(logvar=-40.0)}
    if case == "corrupt":
        path.write_bytes(b"not an npy file")
    else:
        np.save(path, arrays[case])
    got = t_video.validate_existing(str(path), 13)
    assert got == _jax_tool("precompute_video").validate_existing(str(path), 13) == (case == "valid")


def test_reader_names_imageio_when_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="needs the imageio package"):
        t_video.read_video_frames(str(tmp_path / "ep.mp4"), 16, 49)


def test_spatial_shard_under_torchrun_matches_one_device(tmp_path):
    """Two one-frame 480 x 720 episodes through ``main --spatial-shard`` on 2
    gloo ranks: rank 0 writes each once, the posteriors within 1e-4 of the
    per-episode function on one device."""
    import torch_parallel_runs as runs
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder
    from ttt_video_dit_torch.models.vae.enc_dec import Encoder3D

    torch.manual_seed(4)
    enc = Encoder3D(VaeModelConfig(**SHARD_VAE))
    ckpt = tmp_path / "vae.pt"
    torch.save({"state_dict": {f"encoder.{k}": v for k, v in enc.state_dict().items()}}, ckpt)
    eps = _episodes(tmp_path, n=2)
    rng = np.random.default_rng(5)
    frames = {i: rng.integers(0, 256, (1, 480, 720, 3), dtype=np.uint8) for i in range(2)}
    for i, f in frames.items():
        np.save(eps / f"ep{i}.npy", f)
    out = tmp_path / "out"
    proc = runs.torchrun(2, [__file__, "--episode-dir", str(eps), "--save-dir", str(out), "--vae-checkpoint",
                             str(ckpt), "--num-frames", "1", "--spatial-shard", "--device", "cpu"])
    assert "VAE encoder split over H across 2 ranks" in proc.stdout
    written = [ln.split("->")[0] for ln in proc.stdout.splitlines() if "->" in ln]
    assert written == ["[0] 1/2 ep0.mp4 ", "[0] 2/2 ep1.mp4 "]
    assert sorted(os.listdir(out)) == ["ep0.npy", "ep1.npy"]
    vae = VideoAutoencoder.from_torch_checkpoint(str(ckpt), halves=("encoder",))
    for i, f in frames.items():
        want = t_video.encode_episode(vae, f)
        got = np.load(out / f"ep{i}.npy")
        assert got.shape == want.shape == (1, 32, 60, 90)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


if __name__ == "__main__":
    t_video.read_video_frames = lambda path, fps, n: np.load(path[: -len(".mp4")] + ".npy")
    t_video.main(sys.argv[1:])
