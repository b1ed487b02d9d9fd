"""PyTorch port entry points on a CPU-only host: the package never imports
JAX or the JAX package (at run time, and in any import statement), its own
config and sequence modules are faithful copies of the JAX package's, the
sampling entry refuses to run without a GPU unless the CPU is asked for, the
kernel wrappers refuse what their kernels do not take, and chip_smoke.py
fails (printing no result) without a card or outside the repo."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ttt_video_dit_torch  # noqa: E402
from ttt_video_dit_torch import sample  # noqa: E402
from ttt_video_dit_torch.ops import attention, ttt_mlp_kernel  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TINY_SAMPLE = [
    "--job.config_file", "configs/eval/ttt-mlp/3s.toml", "--eval.input_file", "inputs/example.json",
    "--eval.num_denoising_steps", "3", "--guider.num_steps", "3", "--eval.image_height", "64",
    "--eval.image_width", "64", "--eval.txt_maxlen", "16", "--model.latent_height", "4", "--model.latent_width", "4",
    "--model.model_dim", "128", "--model.num_heads", "2", "--model.num_layers", "2",
]


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only behaviour")


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, import without pulling in jax or flax."""
    modules = [m.name for m in pkgutil.walk_packages(ttt_video_dit_torch.__path__, "ttt_video_dit_torch.")]
    code = (
        "import importlib, sys\n"
        f"for name in {modules + ['chip_smoke']!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "ttt_video_dit_torch.sample" in modules and "ttt_video_dit_torch.ops.ttt_mlp_kernel" in modules
    assert "ttt_video_dit_torch.ops.ttt_linear_kernel" in modules and "ttt_video_dit_torch.ops.convert" in modules
    assert {"ttt_video_dit_torch.data.precompute_text", "ttt_video_dit_torch.data.precompute_video",
            "ttt_video_dit_torch.data.native", "ttt_video_dit_torch.parallel.spatial"} <= set(modules)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the model only through ttt_video_dit_torch: none of
    its own import statements names the JAX package or JAX."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert any(n.startswith("ttt_video_dit_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] in ("ttt_video_dit_tpu", "jax", "jaxlib", "flax")]
    assert not bad, bad


FORBIDDEN = ("ttt_video_dit_tpu", "jax", "jaxlib", "flax", "optax")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    return names + [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level]


def test_no_import_statement_names_jax_or_the_jax_package():
    """Every .py file of the port, and chip_smoke.py, parsed with ast: no
    import or from-import of ttt_video_dit_tpu, jax, jaxlib, flax or optax."""
    files = sorted((REPO / "ttt_video_dit_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN}
    assert not bad, bad


TOKENIZER_PACKAGES = ("regex", "tokenizers", "transformers")


def test_no_import_statement_names_regex_tokenizers_or_transformers():
    """Every .py file of the port, and chip_smoke.py, parsed with ast: no
    import of regex, tokenizers or transformers (the card's machine has none
    of them; the tokenizer carries its own grapheme table and character-map
    reader). scripts/gen_torch_grapheme_table.py, which writes the table, may."""
    files = sorted((REPO / "ttt_video_dit_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert REPO / "ttt_video_dit_torch" / "models" / "graphemes.py" in files
    bad = {str(f.relative_to(REPO)): m for f in files for m in _imported_modules(f)
           if m.split(".")[0] in TOKENIZER_PACKAGES}
    assert not bad, bad
    assert "regex" in _imported_modules(REPO / "scripts" / "gen_torch_grapheme_table.py")


TRAIN_ARGS = ["--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "4",
              "--training.steps", "3", "--parallelism.dp_sharding", "1", "--remat.scan_checkpoint_group_size", "8"]
EVAL_ARGS = ["--job.config_file", "configs/eval/ttt-mlp/3s.toml", "--eval.input_file", "inputs/example.json",
             "--model.num_heads", "2", "--eval.txt_maxlen", "16"]
LINEAR_TRAIN_ARGS = ["--job.config_file", "configs/train/ttt-linear/3s.toml", "--model.num_layers", "4"]
LINEAR_EVAL_ARGS = ["--job.config_file", "configs/eval/ttt-linear/3s.toml", "--eval.input_file", "inputs/example.json"]


@pytest.mark.parametrize("argv,eval_mode", [(TRAIN_ARGS, False), (EVAL_ARGS, True), ([], False),
                                            (LINEAR_TRAIN_ARGS, False), (LINEAR_EVAL_ARGS, True)],
                         ids=["train_toml_and_flags", "eval_toml_and_flags", "defaults", "linear_train_toml",
                              "linear_eval_toml"])
def test_config_copies_match_the_jax_package(monkeypatch, argv, eval_mode):
    """The port's JobConfig and ModelConfig copies give the JAX package's
    dataclass fields for the same TOML and flags, and the same presets."""
    import dataclasses

    from ttt_video_dit_torch.config import job_config as t_job, model_config as t_model
    from ttt_video_dit_tpu.config import job_config as j_job, model_config as j_model

    monkeypatch.chdir(REPO)
    jobs = []
    for mod in (t_job, j_job):
        job = mod.JobConfig(eval_mode=eval_mode)
        job.parse_args(list(argv))
        jobs.append(job)
    sections = list(jobs[1]._sections)
    assert sections and list(jobs[0]._sections) == sections
    for name in sections:
        assert dataclasses.asdict(getattr(jobs[0], name)) == dataclasses.asdict(getattr(jobs[1], name)), name
    assert t_model.PREDEFINED_CONFIGS == j_model.PREDEFINED_CONFIGS
    assert t_model.VIDEO_DURATION_CONFIGS == j_model.VIDEO_DURATION_CONFIGS
    for size in t_model.PREDEFINED_CONFIGS:
        got = t_model.ModelConfig.get_preset(size, "3sec", jobs[0])
        want = j_model.ModelConfig.get_preset(size, "3sec", jobs[1])
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.head_dim, got.num_chunks, got.approx_param_count()) == (want.head_dim, want.num_chunks,
                                                                            want.approx_param_count())


@pytest.mark.parametrize("frames,scenes,text,lat", [(13, 1, 498, (60, 90)), (253, 21, 498, (60, 90)), (37, 3, 16, (8, 8))],
                         ids=["3s", "63s", "tiny_multiscene"])
def test_sequence_metadata_copy_matches_the_jax_package(frames, scenes, text, lat):
    """SequenceMetadata's copy gives the same derived geometry (3 s, 63 s, tiny)."""
    from ttt_video_dit_torch.models.sequence import SequenceMetadata as T
    from ttt_video_dit_tpu.models.sequence import SequenceMetadata as J

    kw = dict(text_length=text, num_frames=frames, num_chunks=scenes, tokens_per_frame=(lat[0] // 2) * (lat[1] // 2),
              latent_height=lat[0], latent_width=lat[1])
    got, want = T(**kw), J(**kw)
    props = [n for n in dir(J) if isinstance(getattr(J, n), property)]
    assert len(props) >= 5
    assert {n: getattr(got, n) for n in props} == {n: getattr(want, n) for n in props}
    assert hash(got) == hash(T(**kw))


def test_sample_entry_needs_gpu_unless_cpu_is_asked_for(tmp_path, monkeypatch):
    _no_cuda()
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(sample.parse_args(TINY_SAMPLE + ["--eval.output_dir", str(tmp_path)]))
    summary = sample.main(sample.parse_args(TINY_SAMPLE + ["--eval.output_dir", str(tmp_path), "--job.platform", "cpu"]))
    latents = np.load(tmp_path / "video_0_0_latents.npy")
    assert summary["device"] == "cpu" and len(summary["eval_seconds"]) == 3
    assert latents.shape == (13, 16, 8, 8) and np.isfinite(latents).all()


def _k1_args(F=64, CS=16, dtype=torch.bfloat16, device="cpu"):
    B, H, NC = 1, 2, 3
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=device)
    return [z(B, NC, CS, H * F, dt=dtype), z(B, NC, CS, H * F, dt=dtype), z(B, NC, CS, H * F, dt=dtype),
            z(B, H, NC, CS), z(NC, CS, F), z(NC, CS, F), z(H, F), z(H, F),
            z(H, F, 4 * F), z(H, 1, 4 * F), z(H, 4 * F, F), z(H, 1, F)]


@pytest.mark.parametrize("case", ["cpu_tensors", "head_dim_32", "mini_batch_72", "float32_inputs", "non_contiguous"])
def test_ttt_kernel_rejects_what_it_does_not_take(case):
    if case == "cpu_tensors":
        args = _k1_args()
    elif case == "head_dim_32":
        args = _k1_args(F=32, device="meta")
    elif case == "mini_batch_72":  # a multiple of 8 past the kernels' 64
        args = _k1_args(CS=72, device="meta")
    elif case == "float32_inputs":  # taken on a CUDA device (the float32 kernels); meta tensors are refused
        args = _k1_args(dtype=torch.float32, device="meta")
    else:
        args = _k1_args(device="meta")
        args[8] = args[8].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        ttt_mlp_kernel.check_kernel_args(*args)
    if case != "cpu_tensors":  # a tensor that is neither on the CPU nor launchable: the wrapper raises
        with pytest.raises(ValueError):
            ttt_mlp_kernel.ttt_mlp_forward(*args, eta_scale=1e-3)


@pytest.mark.parametrize("case", ["cpu_tensors", "head_dim_128", "float32", "mismatched_shapes", "too_many_heads"])
def test_attention_kernel_rejects_what_it_does_not_take(case):
    shape, dtype, device = (2, 33, 3, 64), torch.bfloat16, "meta"
    if case == "cpu_tensors":
        device = "cpu"
    elif case == "head_dim_128":
        shape = (2, 33, 3, 128)
    elif case == "float32":
        dtype = torch.float32
    elif case == "too_many_heads":  # heads ride on a grid dimension of at most 65,535 blocks
        shape = (1, 4, 65536, 64)
    q = torch.zeros(shape, dtype=dtype, device=device)
    k = torch.zeros((2, 34, 3, 64) if case == "mismatched_shapes" else shape, dtype=dtype, device=device)
    with pytest.raises(ValueError, match="65,535" if case == "too_many_heads" else None):
        attention.check_kernel_args(q, k, q)
    if device == "meta":
        with pytest.raises(ValueError):
            attention.attention(q, k, q)


def test_chip_smoke_fails_without_a_card_and_outside_the_repo(tmp_path):
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
