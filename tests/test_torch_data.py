"""The port's precomputed-latent loader (ttt_video_dit_torch/data/dataset.py)
against the JAX package's (ttt_video_dit_tpu/data/dataset.py) on the CPU.

The same fabricated JSONL dataset (8 samples: posteriors [2, 2C, 4, 4] and
one scene's text [3, 8], as tests/test_data_feeding.py builds them, here in
.npy, .npz and torch.save'd .pt files, float64 .pt payloads among them) goes
through both DataModules: 5 batches of 3 cross two epoch boundaries (the
2-sample tails are dropped), bit for bit, with equal sampler positions; the
port's stream resumes from a saved state with the batches of an
uninterrupted run (its state also carries the posterior draws' generator);
process shards tile the global batch; the loader retries and then names the
sample; the synthetic module's stream resumes too.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch.data import dataset as t_data  # noqa: E402
from ttt_video_dit_tpu.data import dataset as j_data  # noqa: E402

SCALE = 0.7


@pytest.fixture
def jsonl_dataset(tmp_path):
    """8 samples: posteriors [2, 2C, 4, 4] (mean i + noise, logvar -1 + i/4)
    and text [3, 8] (constant i, so a batch names its samples), in .npy,
    .npz and .pt files."""
    rng = np.random.default_rng(0)
    meta_path = tmp_path / "meta.jsonl"
    with open(meta_path, "w") as f:
        for i in range(8):
            mean = i + rng.standard_normal((2, 2, 4, 4)).astype(np.float32)
            vid = np.concatenate([mean, np.full((2, 2, 4, 4), -1.0 + i / 4, np.float32)], axis=1)
            txt = np.full((3, 8), float(i), np.float32)
            vid_name, txt_name = [(f"vid_{i}.npy", f"txt_{i}.pt"), (f"vid_{i}.pt", f"txt_{i}.npz"),
                                  (f"vid_{i}.npz", f"txt_{i}.npy")][i % 3]
            for name, arr in ((vid_name, vid), (txt_name, txt)):
                if name.endswith(".npy"):
                    np.save(tmp_path / name, arr)
                elif name.endswith(".npz"):
                    np.savez(tmp_path / name, arr)
                else:  # float64 payloads for odd samples: the loader casts .pt to float32
                    torch.save(torch.from_numpy(arr.astype(np.float64 if i % 2 else np.float32)), tmp_path / name)
            f.write(json.dumps({"vid_emb": vid_name, "text_chunk_emb": [txt_name]}) + "\n")
    return str(tmp_path), str(meta_path)


def _ids(batch):
    return batch["text"][:, 0, 0, 0].astype(int).tolist()


def test_load_tensor_matches_jax(jsonl_dataset):
    root, _ = jsonl_dataset
    for name in sorted(os.listdir(root)):
        if name.endswith((".npy", ".npz", ".pt")):
            got, want = t_data.load_tensor(os.path.join(root, name)), j_data.load_tensor(os.path.join(root, name))
            assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), name


def test_posterior_draws_match_jax():
    params = np.random.default_rng(1).standard_normal((3, 4, 5, 5)).astype(np.float32) * 40.0  # logvar clipped
    got = t_data.sample_diagonal_gaussian(params, np.random.default_rng(2))
    want = j_data.sample_diagonal_gaussian(params, np.random.default_rng(2))
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_five_batches_across_epochs_match_jax(jsonl_dataset):
    root, meta = jsonl_dataset
    port = t_data.DataModule(root, SCALE, meta, seed=3)
    ref = j_data.DataModule(root, SCALE, meta, seed=3)
    got_it, want_it = port.batches(3), ref.batches(3)
    epochs = []
    for _ in range(5):
        got, want = next(got_it), next(want_it)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        state = port.sampler.state_dict()
        assert {k: v for k, v in state.items() if k != "rng"} == ref.sampler.state_dict()
        epochs.append(state["epoch_seed"])
        assert got["vid"].shape == (3, 2, 2, 4, 4) and got["text"].shape == (3, 1, 3, 8)
    assert epochs == [0, 0, 1, 1, 2]
    got_it.close()
    want_it.close()


def test_data_resumes_from_a_saved_state(jsonl_dataset):
    """A module restored from the state committed after batch 2 yields
    batches 3-5 of an uninterrupted run, posterior draws included."""
    root, meta = jsonl_dataset
    whole = t_data.DataModule(root, SCALE, meta, seed=3)
    it = whole.batches(3)
    want = [next(it) for _ in range(5)]
    it.close()
    first = t_data.DataModule(root, SCALE, meta, seed=3)
    it = first.batches(3)
    for _ in range(2):
        next(it)
    state = json.loads(json.dumps(first.sampler.state_dict()))  # as a checkpoint's sampler.json keeps it
    it.close()
    resumed = t_data.DataModule(root, SCALE, meta, seed=3)
    resumed.sampler.load_state_dict(state)
    it = resumed.batches(3)
    for w in want[2:]:
        got = next(it)
        assert all(np.array_equal(got[k], w[k]) for k in w)
    assert resumed.sampler.state_dict() == whole.sampler.state_dict()
    it.close()


@pytest.mark.parametrize("process_count", [2, 3])
def test_process_shards_tile_the_global_batch(jsonl_dataset, process_count):
    root, meta = jsonl_dataset
    global_bs = 6
    mods = [t_data.DataModule(root, SCALE, meta, seed=0, process_index=i, process_count=process_count)
            for i in range(process_count)]
    refs = [j_data.DataModule(root, SCALE, meta, seed=0, process_index=i, process_count=process_count)
            for i in range(process_count)]
    whole = next(t_data.DataModule(root, SCALE, meta, seed=0).batches(global_bs))
    shards = [next(m.batches(global_bs)) for m in mods]
    assert [i for s in shards for i in _ids(s)] == _ids(whole)
    for s, r in zip(shards, refs):
        want = next(r.batches(global_bs))
        assert s["vid"].shape[0] == global_bs // process_count
        assert all(np.array_equal(s[k], want[k]) for k in want)
    assert all(m.sampler.counter == global_bs for m in mods)


def test_loader_retries_then_names_the_sample(jsonl_dataset, monkeypatch):
    root, meta = jsonl_dataset
    ds = t_data.PreembeddingDataset(root, SCALE, meta)
    calls = {"n": 0}
    load = t_data.load_tensor

    def flaky(path):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise OSError("transient")
        return load(path)

    monkeypatch.setattr(t_data, "load_tensor", flaky)
    assert ds[0]["vid"].shape == (2, 2, 4, 4)
    monkeypatch.setattr(t_data, "load_tensor", lambda path: (_ for _ in ()).throw(OSError("gone")))
    with pytest.raises(RuntimeError, match="sample 5 after 10 retries"):
        ds[5]
    from ttt_video_dit_torch.data import native

    monkeypatch.setattr(native, "available", lambda: False)  # the failure is injected into the Python reads
    mod = t_data.DataModule(root, SCALE, meta)
    with pytest.raises(RuntimeError, match="after 10 retries"):  # the worker's error reaches the consumer
        next(mod.batches(2))


def test_synthetic_stream_matches_jax_and_resumes():
    shapes = dict(vid_shape=(2, 4, 4, 4), text_shape=(1, 8, 16))
    port, ref = t_data.SyntheticDataModule(**shapes, seed=5), j_data.SyntheticDataModule(**shapes, seed=5)
    got_it, want_it = port.batches(2), ref.batches(2)
    got = [next(got_it) for _ in range(4)]
    for g in got:
        w = next(want_it)
        assert all(np.array_equal(g[k], w[k]) for k in w)
    assert port.sampler.counter == ref.sampler.counter == 8
    first = t_data.SyntheticDataModule(**shapes, seed=5)
    it = first.batches(2)
    next(it), next(it)
    resumed = t_data.SyntheticDataModule(**shapes, seed=5)
    resumed.sampler.load_state_dict(json.loads(json.dumps(first.sampler.state_dict())))
    it = resumed.batches(2)
    for g in got[2:]:
        b = next(it)
        assert all(np.array_equal(b[k], g[k]) for k in g)
    assert resumed.sampler.state_dict() == port.sampler.state_dict()
