"""The port's native reader (ttt_video_dit_torch/data/native.py and its copy
of the JAX package's _native/npy_loader.cpp) and the loader that reads
through it (ttt_video_dit_torch/data/dataset.py).

The JAX package's tests of its reader (tests/test_native_loader.py) run
again here on the port's reader and loader:
- ``.npy`` dtypes and 0-d;
- ``.npz`` stored and deflated;
- single-tensor and dict ``.pt`` files;
- the pool's submit/fetch/discard/wait;
- pooled batches against sequential ones.
Like those, they skip where the reader does not build (no g++ or zlib).

These always run:
- the C++ source is byte-equal to the JAX package's;
- the port's DataModule with the pool gives the batches it gives without
  (every file read in Python), and the JAX DataModule's, bit for bit, on
  tests/test_torch_data.py's fabricated .npy/.npz/.pt dataset;
- with the build failing, ``available()`` is False, ``build_error()`` says
  why, and the loader reads in Python, yielding the same batches;
- the training entry logs, once, whether the reader is in use.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_data import jsonl_dataset  # noqa: E402,F401  (a fixture)
from ttt_video_dit_torch.data import dataset as t_data  # noqa: E402
from ttt_video_dit_torch.data import native  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
needs_reader = pytest.mark.skipif(not native.available(), reason="the native reader does not build here (g++/zlib)")


@needs_reader
@pytest.mark.parametrize("dtype,shape", [(np.float32, (3, 4, 5)), (np.float16, (7,)), (np.float64, (2, 2)),
                                         (np.int64, (4, 1)), (np.uint8, (16, 3)), (np.float32, ())])
def test_native_matches_numpy(tmp_path, dtype, shape):
    arr = (np.random.default_rng(0).standard_normal(shape) * 100).astype(dtype)
    p = str(tmp_path / "x.npy")
    np.save(p, arr)
    out = native.load_npy(p)
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)


@needs_reader
@pytest.mark.parametrize("compressed", [False, True])
def test_native_npz_matches_numpy(tmp_path, compressed):
    """The first member of a stored (np.savez) or deflated (np.savez_compressed) .npz."""
    rng = np.random.default_rng(4)
    first, second = rng.standard_normal((6, 5)).astype(np.float32), rng.standard_normal((3,))
    p = str(tmp_path / "c.npz")
    (np.savez_compressed if compressed else np.savez)(p, vid=first, aux=second)
    out = native.load_npy(p)
    np.testing.assert_array_equal(out, first)
    ref = np.load(p)
    np.testing.assert_array_equal(out, ref[list(ref.keys())[0]])


@needs_reader
def test_load_tensor_npz_roundtrip(tmp_path):
    arr = np.random.default_rng(5).standard_normal((4, 7)).astype(np.float32)
    p = str(tmp_path / "z.npz")
    np.savez_compressed(p, x=arr)
    np.testing.assert_array_equal(t_data.load_tensor(p), arr)


@needs_reader
def test_npz_in_prefetch_pool(tmp_path):
    arr = np.random.default_rng(6).standard_normal((8, 8)).astype(np.float16)
    p = str(tmp_path / "p.npz")
    np.savez(p, a=arr)
    pool = native.PrefetchPool(num_threads=1)
    try:
        np.testing.assert_array_equal(pool.wait(pool.fetch(p)), arr)
    finally:
        pool.close()


@needs_reader
def test_native_npz_rejects_non_npy_zip(tmp_path):
    import zipfile

    p = str(tmp_path / "bad.npz")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("readme.txt", "not an array")
    with pytest.raises(IOError):
        native.load_npy(p)


@needs_reader
def test_native_rejects_fortran_order(tmp_path):
    p = str(tmp_path / "f.npy")
    np.save(p, np.asfortranarray(np.arange(12, dtype=np.float32).reshape(3, 4)))
    with pytest.raises(IOError):
        native.load_npy(p)


@needs_reader
def test_prefetch_pool_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    arrays = {i: rng.standard_normal((32, 16)).astype(np.float32) for i in range(8)}
    pool = native.PrefetchPool(num_threads=3)
    try:
        for i, a in arrays.items():
            np.save(tmp_path / f"a{i}.npy", a)
            pool.submit(i, str(tmp_path / f"a{i}.npy"))
        for i in reversed(sorted(arrays)):  # out of submission order
            np.testing.assert_array_equal(pool.wait(i), arrays[i])
    finally:
        pool.close()


@needs_reader
def test_pool_reports_missing_file(tmp_path):
    pool = native.PrefetchPool(num_threads=1)
    try:
        pool.submit(99, str(tmp_path / "nope.npy"))
        with pytest.raises(IOError):
            pool.wait(99)
        pool.discard(pool.fetch(str(tmp_path / "nope.npy")))  # errors dropped
        with pytest.raises(IOError):
            pool.wait(12345)  # an id never submitted
    finally:
        pool.close()


@needs_reader
def test_load_tensor_uses_native_path(tmp_path, monkeypatch):
    arr = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    p = str(tmp_path / "t.npy")
    np.save(p, arr)
    calls = []
    load = native.load_npy
    monkeypatch.setattr(native, "load_npy", lambda path: calls.append(path) or load(path))
    np.testing.assert_array_equal(t_data.load_tensor(p), arr)
    assert calls == [p]
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(t_data.load_tensor(p), arr)
    assert calls == [p]


@needs_reader
@pytest.mark.parametrize("dtype,shape", [("float32", (3, 4, 5)), ("float16", (7, 2)), ("bfloat16", (30, 20)),
                                         ("float64", (2, 3)), ("int64", (4, 6)), ("uint8", (5, 5)),
                                         ("float32", ())])
def test_native_pt_matches_torch(tmp_path, dtype, shape):
    """torch .pt zips read natively; bf16 widens to float32 as .float() does."""
    t = (torch.rand(shape, dtype=torch.float64) * 100).to(getattr(torch, dtype))
    p = str(tmp_path / "t.pt")
    torch.save(t, p)
    got = native.load_npy(p)
    want = t.to(torch.float32).numpy() if dtype == "bfloat16" else t.numpy()
    assert got.shape == tuple(t.shape) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@needs_reader
def test_native_pt_strided_views(tmp_path):
    base = torch.randn(10, 12)
    for name, view in [("transposed", base.t()), ("sliced", base[2:7, 1:9]), ("strided", base[::2, ::3]),
                       ("empty", torch.zeros(0, 4))]:
        p = str(tmp_path / f"{name}.pt")
        torch.save(view, p)
        np.testing.assert_array_equal(native.load_npy(p), view.numpy(), err_msg=name)


@needs_reader
def test_native_pt_rejects_non_tensor(tmp_path):
    """A dict .pt is refused by the single-tensor read; load_tensor's Python path refuses it too."""
    p = str(tmp_path / "d.pt")
    torch.save({"a": torch.randn(2)}, p)
    with pytest.raises(IOError):
        native.load_npy(p)
    with pytest.raises(Exception):
        t_data.load_tensor(p)


@needs_reader
def test_load_tensor_pt_contract(tmp_path, monkeypatch):
    """load_tensor('.pt') is float32 whatever was stored, as the Python path's .to(torch.float32)."""
    for dt in (torch.float16, torch.bfloat16, torch.float32):
        t = torch.randn(6, 7).to(dt)
        p = str(tmp_path / "x.pt")
        torch.save(t, p)
        out = t_data.load_tensor(p)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out, t.to(torch.float32).numpy())
        with monkeypatch.context() as m:
            m.setattr(native, "available", lambda: False)
            np.testing.assert_array_equal(out, t_data.load_tensor(p))


@needs_reader
def test_pt_in_prefetch_pool(tmp_path):
    t = torch.randn(8, 8, dtype=torch.float16)
    p = str(tmp_path / "p.pt")
    torch.save(t, p)
    pool = native.PrefetchPool(num_threads=1)
    try:
        np.testing.assert_array_equal(pool.wait(pool.fetch(p)), t.numpy())
    finally:
        pool.close()


def _pooled(make, indices, threads=2):
    pool = native.PrefetchPool(num_threads=threads)
    try:
        return make().load_batch(indices, pool)
    finally:
        pool.close()


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@needs_reader
def test_load_batch_pool_pt_matches_sequential(tmp_path):
    """bf16 .pt posteriors and float32 .pt text through the pool == the sequential path."""
    g = torch.Generator().manual_seed(0)
    jsonl = tmp_path / "meta.jsonl"
    with open(jsonl, "w") as f:
        for i in range(4):
            torch.save(torch.randn(3, 4, 2, 2, generator=g).to(torch.bfloat16), tmp_path / f"vid{i}.pt")
            texts = []
            for s in range(2):
                torch.save(torch.randn(5, 8, generator=g), tmp_path / f"txt{i}_{s}.pt")
                texts.append(str(tmp_path / f"txt{i}_{s}.pt"))
            f.write(json.dumps({"vid_emb": str(tmp_path / f"vid{i}.pt"), "text_chunk_emb": texts}) + "\n")
    make = lambda: t_data.PreembeddingDataset(None, 0.7, str(jsonl), seed=11)  # noqa: E731
    _assert_same(make().load_batch([2, 0, 3]), _pooled(make, [2, 0, 3]))


def _make_dataset(tmp_path, n=6, scenes=2, broken=()):
    """A tiny dataset; samples in ``broken`` get a corrupt posterior file."""
    rng = np.random.default_rng(3)
    jsonl = tmp_path / "meta.jsonl"
    with open(jsonl, "w") as f:
        for i in range(n):
            vid = tmp_path / f"vid{i}.npy"
            if i in broken:
                vid.write_bytes(b"not an npy file")
            else:
                np.save(vid, rng.standard_normal((3, 4, 2, 2)).astype(np.float32))
            texts = []
            for s in range(scenes):
                np.save(tmp_path / f"txt{i}_{s}.npy", rng.standard_normal((5, 8)).astype(np.float32))
                texts.append(str(tmp_path / f"txt{i}_{s}.npy"))
            f.write(json.dumps({"vid_emb": str(vid), "text_chunk_emb": texts}) + "\n")
    return lambda: t_data.PreembeddingDataset(None, 0.7, str(jsonl), seed=11)


@needs_reader
def test_load_batch_pool_matches_sequential(tmp_path):
    """Pooled reads, the posterior draws in sample order after them: bit-equal to self[i] one at a time."""
    make = _make_dataset(tmp_path)
    _assert_same(make().load_batch([4, 0, 2, 5]), _pooled(make, [4, 0, 2, 5], threads=3))


@needs_reader
def test_load_batch_falls_back_per_sample(tmp_path):
    """A corrupt file in a pooled batch raises the sequential path's error
    after its retries; a batch without it loads."""
    make = _make_dataset(tmp_path, broken={1})
    pool = native.PrefetchPool(num_threads=2)
    try:
        assert len(make().load_batch([0, 2, 3], pool)) == 3
        with pytest.raises(RuntimeError, match="after 10 retries"):
            make().load_batch([0, 1, 2], pool)
    finally:
        pool.close()


@needs_reader
def test_datamodule_pool_error_reaches_the_consumer(tmp_path):
    """A corrupt file read through the DataModule's pool: the worker's retried error is raised to the consumer."""
    _make_dataset(tmp_path, n=4, broken={0, 1, 2, 3})
    module = t_data.DataModule(None, 0.7, str(tmp_path / "meta.jsonl"))
    assert module.native_reader
    with pytest.raises(RuntimeError, match="after 10 retries"):
        next(module.batches(2))


@needs_reader
def test_pt_dict_matches_torch(tmp_path):
    """A state-dict .pt (the reference VAE checkpoint's format): nested dicts
    flattened with dots, non-tensor values dropped, tensors bit-equal to
    torch.load's, bf16 widened."""
    m = torch.nn.Sequential(torch.nn.Conv3d(2, 3, (1, 3, 3)), torch.nn.GroupNorm(1, 3), torch.nn.Linear(4, 5))
    sd = m.state_dict()
    sd["halfw"] = torch.randn(3, 4).to(torch.bfloat16)
    p = str(tmp_path / "ckpt.pt")
    torch.save({"state_dict": sd, "global_step": 1234, "note": "hello"}, p)
    got = native.load_pt_dict(p)
    want = torch.load(p, map_location="cpu", weights_only=False)["state_dict"]
    assert set(got) == {f"state_dict.{k}" for k in want}
    for k, t in want.items():
        np.testing.assert_array_equal(got[f"state_dict.{k}"], t.to(torch.float32).numpy() if t.dtype == torch.bfloat16
                                      else t.numpy(), err_msg=k)


@needs_reader
def test_pt_dict_flat_and_views(tmp_path):
    base = torch.randn(6, 8)
    p = str(tmp_path / "flat.pt")
    torch.save({"base": base, "t": base.t(), "slice": base[1:5, 2:7]}, p)
    got = native.load_pt_dict(p)
    np.testing.assert_array_equal(got["base"], base.numpy())
    np.testing.assert_array_equal(got["t"], base.t().numpy())
    np.testing.assert_array_equal(got["slice"], base[1:5, 2:7].numpy())


@needs_reader
def test_pt_dict_rejects_single_tensor(tmp_path):
    p = str(tmp_path / "single.pt")
    torch.save(torch.randn(3), p)
    with pytest.raises(IOError):
        native.load_pt_dict(p)


@needs_reader
def test_vae_checkpoint_native_equals_torch_path(tmp_path):
    """The reference-key VAE checkpoint read natively equals the port's
    torch.load of it, the tensors its loader builds the VAE from."""
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder

    cfg = VaeModelConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4)
    torch.manual_seed(0)
    vae = VideoAutoencoder(cfg, cfg)
    sd = {f"{half}.{k}": v for half in ("encoder", "decoder") for k, v in getattr(vae, half).state_dict().items()}
    p = str(tmp_path / "vae.pt")
    torch.save({"state_dict": {**sd, "loss.disc.weight": torch.randn(2, 2)}}, p)
    got = native.load_pt_dict(p)
    loaded = VideoAutoencoder.from_torch_checkpoint(p).state_dict()
    assert {k for k in got if not k.startswith("state_dict.loss.")} == {f"state_dict.{k}" for k in loaded}
    for k, v in loaded.items():
        np.testing.assert_array_equal(got[f"state_dict.{k}"], v.numpy(), err_msg=k)


# ---------------------------------------------------------------- always run
def test_cpp_source_is_a_byte_copy_of_the_jax_package():
    got = (REPO / "ttt_video_dit_torch" / "data" / "_native" / "npy_loader.cpp").read_bytes()
    assert got == (REPO / "ttt_video_dit_tpu" / "data" / "_native" / "npy_loader.cpp").read_bytes()
    assert native.SOURCE == REPO / "ttt_video_dit_torch" / "data" / "_native" / "npy_loader.cpp"


def _take(module, n=3, batch=3, **kwargs):
    it = module.batches(batch, **kwargs)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("native_reader", [True, False])
def test_datamodule_batches_with_and_without_the_pool_match_jax(jsonl_dataset, native_reader, monkeypatch):
    """5 batches of 3 across two epochs: the port's module (the pool where the
    reader builds, or every file in Python with the reader switched off) ==
    the JAX package's."""
    from ttt_video_dit_tpu.data import dataset as j_data

    root, meta = jsonl_dataset
    built = native.available()
    if not native_reader:
        monkeypatch.setattr(native, "available", lambda: False)
    port = t_data.DataModule(root, 0.7, meta, seed=3)
    assert port.native_reader == (native_reader and built)
    ref = j_data.DataModule(root, 0.7, meta, seed=3)
    got, want = _take(port, 5), _take(ref, 5, prefetch=1)
    for a, b in zip(got, want):
        for k in ("vid", "text"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    state = port.sampler.state_dict()
    assert {k: state[k] for k in ("epoch_seed", "counter")} == ref.sampler.state_dict() == {"epoch_seed": 2,
                                                                                            "counter": 3}


@pytest.fixture
def unbuildable(tmp_path, monkeypatch):
    """The reader's build failing (no g++ on PATH, an empty build directory)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "")
    yield  # monkeypatch restores the reader's state, so the next caller loads the real one


def test_without_a_compiler_the_loader_reads_in_python(jsonl_dataset, unbuildable):
    from ttt_video_dit_tpu.data import dataset as j_data

    root, meta = jsonl_dataset
    assert not native.available() and "FileNotFoundError" in native.build_error()
    with pytest.raises(RuntimeError, match="native reader unavailable"):
        native.PrefetchPool()
    port = t_data.DataModule(root, 0.7, meta, seed=3)
    assert not port.native_reader
    got = _take(port)
    want = _take(j_data.DataModule(root, 0.7, meta, seed=3), prefetch=1)
    for a, b in zip(got, want):
        for k in ("vid", "text"):
            np.testing.assert_array_equal(a[k], b[k])


def test_training_entry_logs_the_reader_once(tmp_path, capsys):
    from tests.test_torch_resume import TINY, _dataset
    from ttt_video_dit_torch import train

    data = tmp_path / "data"
    data.mkdir()
    flags = [*TINY, *_dataset(data), "--training.steps", "1", "--checkpoint.interval", "0", "--job.dump_folder",
             str(tmp_path / "run")]
    summary = train.main(train.parse_args(flags))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "native reader" in ln]
    assert summary["native_reader"] == native.available() and len(lines) == 1
    assert ("native reader in use" if native.available() else "native reader unavailable") in lines[0]
    assert (tmp_path / "run" / "logs").is_dir() and np.isfinite(summary["losses"]).all()
