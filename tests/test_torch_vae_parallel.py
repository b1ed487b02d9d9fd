"""The port's VAE split over H across gloo ranks on the CPU
(``VideoAutoencoder(group=...)``, ttt_video_dit_torch/parallel/spatial.py;
the port's form of the JAX package's ``VideoAutoencoder(mesh=...)``).

Under torchrun at worlds 2, 3 and 4, each rank passes the whole input and
returns the whole output. The inputs are tests/test_vae.py:257's: 9 frames
of 32 x 32 encoded in windows of 8 + 1, then the posterior's mean decoded in
windows of 2 latent frames. Two configs are used:
- the tiny one (ch 32, ch_mult (1, 2): 2 pixel rows a latent row; 16 latent
  rows, split 8/8, 6/5/5 at world 3, 4 x 4);
- a 4-level one (ch_mult (1, 1, 2, 2): 8 rows a latent row; 4 latent rows,
  2/1/1 at world 3, one a rank at world 4).

Every rank's outputs equal rank 0's bit for bit. They are held to the
unsharded port and to the JAX VAE on the same parameters with
|got - want| <= 1e-4 max|want| + 1e-4 |want|. The halo rows carry the
neighbours' values exactly, and the norms' moments are summed in another
order (the fast variance, as flax computes it).

A group of one runs the one-device code, bit-equal. Ranks that pass inputs
of different shapes get a ValueError naming them. The sampling entry at tp 2
decodes over its tensor group.

Run under torchrun, this file is the ranks' worker::

    python -m torch.distributed.run --standalone --nproc_per_node N tests/test_torch_vae_parallel.py DIR
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from ttt_video_dit_torch.config.model_config import VaeModelConfig  # noqa: E402
from ttt_video_dit_torch.models.vae import autoencoder as t_ae  # noqa: E402
from ttt_video_dit_torch.parallel import spatial  # noqa: E402

torch.set_num_threads(1)
CONFIGS = {"tiny": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, resolution=32, dropout=0.0),
           "four_levels": dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=4, resolution=32,
                               dropout=0.0)}


def _vae(name, group=None):
    cfg = VaeModelConfig(**CONFIGS[name])
    return t_ae.VideoAutoencoder(cfg, cfg, group=group).eval()


def _run(vae, x, z_channels=4):
    z = vae.encode_first_stage(torch.from_numpy(x), window=8)
    return z.numpy(), vae.decode_first_stage(z[:, :z_channels], window=2).numpy()


def _worker(out_dir: str) -> None:
    """Each config's encode and decode split over the world; each rank saves
    what it returns. At world 2, rank 1 then passes a shorter input."""
    dist.init_process_group("gloo")
    rank, world = dist.get_rank(), dist.get_world_size()
    x = np.load(os.path.join(out_dir, "x.npy"))
    out = {}
    for name in CONFIGS:
        vae = _vae(name, dist.group.WORLD)
        vae.load_state_dict(torch.load(os.path.join(out_dir, f"{name}.pt"), weights_only=True))
        out[f"{name}_z"], out[f"{name}_frames"] = _run(vae, x)
    if world == 2:
        try:
            vae.encode_first_stage(torch.from_numpy(x[:, :, : 1 if rank else 9]), window=8)
        except ValueError as e:
            out["refused"] = np.array(str(e))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX VAEs' parameters in each config carried into the port, the input,
    and the unsharded port's and the JAX package's outputs."""
    from tests.test_torch_vae import _jax_vae, _port_vae

    d = tmp_path_factory.mktemp("vae_parallel")
    x = np.random.default_rng(0).standard_normal((1, 3, 9, 32, 32)).astype(np.float32)
    np.save(d / "x.npy", x)
    want = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        jvae = _jax_vae(kw, seed=20 + i)
        vae = _port_vae(jvae, kw)
        torch.save(vae.state_dict(), d / f"{name}.pt")
        z, frames = _run(vae, x)
        jz = np.asarray(jvae.encode_first_stage(x, window=8))
        want[name] = {"port": (z, frames), "jax": (jz, np.asarray(jvae.decode_first_stage(jz[:, :4], window=2)))}
    return d, want


def _close(got, want, tol=1e-4):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("world", [2, 3, 4])
def test_split_encode_and_decode_match_one_device_and_jax(inputs, world):
    import torch_parallel_runs as runs

    d, want = inputs
    out = d / f"world{world}"
    out.mkdir()
    (out / "x.npy").write_bytes((d / "x.npy").read_bytes())
    for name in CONFIGS:
        (out / f"{name}.pt").write_bytes((d / f"{name}.pt").read_bytes())
    runs.torchrun(world, [__file__, str(out)])
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    for name in CONFIGS:
        z, frames = ranks[0][f"{name}_z"], ranks[0][f"{name}_frames"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{name}_z"], z)
            np.testing.assert_array_equal(r[f"{name}_frames"], frames)
        assert z.shape == want[name]["port"][0].shape and frames.shape == (1, 3, 9, 32, 32)
        for source in ("port", "jax"):
            _close(z, want[name][source][0])
            _close(frames, want[name][source][1])
    if world == 2:
        for r in ranks:
            assert str(r["refused"]) == ("the ranks of the VAE's group hold inputs of different shapes: "
                                         "rank 0 [1, 3, 9, 32, 32], rank 1 [1, 3, 1, 32, 32]")


def test_group_of_one_is_the_one_device_code(inputs, tmp_path):
    d, want = inputs
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        x = np.load(d / "x.npy")
        for name in CONFIGS:
            vae = _vae(name, dist.group.WORLD)
            vae.load_state_dict(torch.load(d / f"{name}.pt", weights_only=True))
            assert vae.shard is None
            z, frames = _run(vae, x)
            np.testing.assert_array_equal(z, want[name]["port"][0])
            np.testing.assert_array_equal(frames, want[name]["port"][1])
    finally:
        dist.destroy_process_group()


def test_tp2_sampling_decodes_the_vae_over_the_tensor_group(tmp_path):
    """With --eval.vae_checkpoint_path at tp 2, the two tensor ranks decode
    together, split over H (4 of the 8 latent rows each), and tensor rank 0
    writes the frames: one process's decode of the same latents within
    1e-4 max|x| + 1e-4 |x|, seen through the uint8 map (each byte lies
    between those of the bounds)."""
    import torch_parallel_runs as runs
    from tests.test_torch_parallel_sample import TINY_EVAL
    from tests.test_torch_sample_entry import _vae_checkpoint
    from ttt_video_dit_torch import sample

    vae_path = _vae_checkpoint(tmp_path)
    out = tmp_path / "tp2"
    proc = runs.torchrun(2, ["-m", "ttt_video_dit_torch.sample", *TINY_EVAL, "--eval.input_file", "inputs/example.json",
                             "--eval.vae_checkpoint_path", str(vae_path), "--parallelism.tp_sharding", "2",
                             "--eval.output_dir", str(out)])
    assert "split over 2 tensor ranks; wrote" in proc.stdout
    assert sorted(p.name for p in out.iterdir()) == ["video_0_0.npz", "video_0_0_latents.npy"]
    frames = np.load(out / "video_0_0.npz")["frames"]
    latents = torch.from_numpy(np.load(out / "video_0_0_latents.npy"))
    want = t_ae.VideoAutoencoder.load_decoder(str(vae_path)).decode(latents)
    tol = 1e-4 * float(want.abs().max()) + 1e-4 * want.abs()
    lo, hi = (sample.frames_to_uint8(want + sign * tol) for sign in (-1, 1))
    assert frames.shape == lo.shape == (49, 64, 64, 3) and frames.std() > 0
    assert ((lo <= frames) & (frames <= hi)).all()


@pytest.mark.parametrize("h,n,want", [(16, 2, [(0, 8), (8, 16)]), (16, 3, [(0, 6), (6, 11), (11, 16)]),
                                      (60, 8, [(0, 8), (8, 16), (16, 24), (24, 32), (32, 39), (39, 46), (46, 53),
                                               (53, 60)]), (4, 4, [(0, 1), (1, 2), (2, 3), (3, 4)])])
def test_split_rows(h, n, want):
    """As even as can be, the first h mod n ranks one more (60 latent rows of
    480 x 720 over 8 ranks: 4 ranks of 8, then 4 of 7)."""
    got = spatial.split_rows(h, n)
    assert got == want and sum(b - a for a, b in got) == h
    sizes = [b - a for a, b in got]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_split_rows_refuses_more_ranks_than_rows():
    with pytest.raises(ValueError, match="3 latent rows cannot be split over 4 ranks"):
        spatial.split_rows(3, 4)


if __name__ == "__main__":
    _worker(sys.argv[1])
