"""The port's 3D causal VAE (ttt_video_dit_torch/models/vae) against the JAX
package's flax VAE on the CPU, with the flax parameters carried across by
``convert.flax_vae_to_state_dict`` (a strict load): the decoder and encoder
on one window, the tiled decode and encode (caches threaded between windows;
the regularized sample with injected noise), the conv-time chunking, the
nearest resize, loading the reference's torch-key checkpoint, and the
``T % window`` check.

Config: tests/test_vae.py's tiny one (ch 32, ch_mult (1, 2), 1 res block,
z 4), and a 4-level one (ch 32, ch_mult (1, 1, 2, 2)) for the full 4x / 8x
compression. Tolerance, float32 on the CPU: |port - jax| <= 1e-4 * max|jax|
+ 1e-4 * |jax| (float32 convolutions and GroupNorm statistics, flax's fast
variance against torch's, summed in another order through ~10-25 layers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.vae import autoencoder as t_ae  # noqa: E402
from ttt_video_dit_torch.models.vae import enc_dec as t_vae  # noqa: E402
from ttt_video_dit_tpu.config.model_config import VaeModelConfig as JaxVaeConfig  # noqa: E402
from ttt_video_dit_tpu.models.vae import autoencoder as j_ae  # noqa: E402
from ttt_video_dit_tpu.models.vae import enc_dec as j_vae  # noqa: E402
from ttt_video_dit_torch.config.model_config import VaeModelConfig  # noqa: E402

torch.set_num_threads(1)
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, resolution=32, dropout=0.0)
FOUR_LEVELS = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=4, resolution=32, dropout=0.0)
CONFIGS = {"tiny": TINY, "four_levels": FOUR_LEVELS}


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


def _random_params(module, x, seed):
    """Random float32 values of the flax tree's shapes (eval_shape: no init
    run): fan-in-scaled kernels, GroupNorm scales near 1, small biases, so a
    wrong mapping shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        noise = rng.standard_normal(s.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            value = noise / np.sqrt(np.prod(s.shape[:-1]))
        else:
            value = 1.0 + 0.1 * noise if name == "scale" else 0.1 * noise
        return value.astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x)))["params"]
    return {"params": jax.tree_util.tree_map_with_path(leaf, shapes)}


def _jax_vae(kw, seed=0):
    cfg = JaxVaeConfig(**kw)
    vae = j_ae.VideoAutoencoder(cfg, cfg)
    vae.enc_params = _random_params(vae.encoder, (1, 1, 16, 16, 3), seed)
    vae.dec_params = _random_params(vae.decoder, (1, 1, 4, 4, kw["z_channels"]), seed + 1)
    return vae


def _port_vae(jvae, kw, scale_factor=1.0):
    cfg = VaeModelConfig(**kw)
    vae = t_ae.VideoAutoencoder(cfg, cfg, scale_factor=scale_factor)
    vae.encoder.load_state_dict(convert.flax_vae_to_state_dict(jvae.enc_params), strict=True)
    vae.decoder.load_state_dict(convert.flax_vae_to_state_dict(jvae.dec_params), strict=True)
    return vae.eval()


@pytest.mark.parametrize("config", CONFIGS)
def test_decoder_and_encoder_match_jax_on_one_window(rng, config):
    kw = CONFIGS[config]
    jvae = _jax_vae(kw)
    vae = _port_vae(jvae, kw)
    z = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want, _ = jvae._dec_apply(jvae.dec_params, jnp.asarray(z).transpose(0, 2, 3, 4, 1), first=True)
    with torch.no_grad():
        got = vae.decoder(torch.from_numpy(z), {})
    _close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3))
    levels = len(kw["ch_mult"]) - 1
    assert got.shape == (1, 3, 1 + 2 * 2 ** min(levels, 2), 4 * 2**levels, 4 * 2**levels)

    x = rng.standard_normal((1, 3, 5, 16, 16)).astype(np.float32)
    want, _ = jvae._enc_apply(jvae.enc_params, jnp.asarray(x).transpose(0, 2, 3, 4, 1), first=True)
    with torch.no_grad():
        got = vae.encoder(torch.from_numpy(x), {})
    _close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3))


@pytest.mark.parametrize("config", CONFIGS)
def test_tiled_decode_matches_jax(rng, config):
    """Five latent frames in windows of 3 + 2 frames, the conv caches carried;
    the scale factor divides the latents first; ``decode``'s frame layout."""
    kw = CONFIGS[config]
    jvae = _jax_vae(kw, seed=3)
    jvae.scale_factor = 0.7
    vae = _port_vae(jvae, kw, scale_factor=0.7)
    z = rng.standard_normal((1, 4, 5, 4, 4)).astype(np.float32)
    want = np.asarray(jvae.decode_first_stage(z, window=2))
    got = vae.decode_first_stage(torch.from_numpy(z), window=2).numpy()
    _close(got, want)
    frames = vae.decode(torch.from_numpy(z[0].transpose(1, 0, 2, 3))).numpy()
    _close(frames, jvae.decode(z[0].transpose(1, 0, 2, 3)))
    # A second video starts from empty caches: decoding again gives the same frames.
    np.testing.assert_array_equal(vae.decode_first_stage(torch.from_numpy(z), window=2).numpy(), got)


def test_tiled_encode_matches_jax(rng):
    """Nine frames in windows of 5 + 4 (the caches carried), the posterior,
    then the regularized sample with injected noise and the scale factor."""
    jvae = _jax_vae(TINY, seed=5)
    vae = _port_vae(jvae, TINY, scale_factor=0.7)
    jvae.scale_factor = 0.7
    x = rng.standard_normal((1, 3, 9, 16, 16)).astype(np.float32)
    want = np.asarray(jvae.encode_first_stage(x, window=4))
    got = vae.encode_first_stage(torch.from_numpy(x), window=4).numpy()
    _close(got, want)
    assert got.shape == (1, 8, 5, 8, 8)
    noise = rng.standard_normal((1, 4, 5, 8, 8)).astype(np.float32)
    want = np.asarray(jvae.encode_first_stage(x, unregularized=False, window=4, noise=noise,
                                              multiply_by_scale_factor=True))
    got = vae.encode_first_stage(torch.from_numpy(x), unregularized=False, window=4, noise=torch.from_numpy(noise),
                                 multiply_by_scale_factor=True).numpy()
    _close(got, want)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    a = vae.encode_first_stage(torch.from_numpy(x), unregularized=False, window=4, generator=gen())
    b = vae.encode_first_stage(torch.from_numpy(x), unregularized=False, window=4, generator=gen())
    assert a.shape == (1, 4, 5, 8, 8) and torch.isfinite(a).all() and torch.equal(a, b)


def test_encode_rejects_untileable_frame_count(rng):
    vae = t_ae.VideoAutoencoder(VaeModelConfig(**TINY), None).eval()
    with pytest.raises(AssertionError, match="n\\*4 \\+ 1"):
        vae.encode_first_stage(torch.zeros(1, 3, 8, 32, 32), window=4)
    with pytest.raises(ValueError, match="generator"):
        vae.encode_first_stage(torch.zeros(1, 3, 5, 32, 32), unregularized=False, window=4)
    assert vae.encode_first_stage(torch.zeros(1, 3, 13, 32, 32), window=4).shape[2] == 7  # 13 = 3 * 4 + 1


def test_conv_time_chunks_cover_exactly_and_match_jax():
    for t_out in (1, 2, 9, 49):
        for nbytes, limit in ((100, 1000), (200, 100), (300, 100), (700, 100), (10**10, 2**31)):
            got = t_vae._conv_time_chunks(t_out, nbytes, limit)
            assert got == j_vae._conv_time_chunks(t_out, nbytes, limit)
            assert got[0][0] == 0 and got[-1][1] == t_out and all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_chunked_conv_is_exact(rng, monkeypatch):
    """CONV_CHUNK_BYTES small enough to split every conv: the same encode and
    decode (each output frame is one conv over the same input frames)."""
    cfg = VaeModelConfig(**TINY)
    torch.manual_seed(0)
    vae = t_ae.VideoAutoencoder(cfg, cfg).eval()
    x = torch.from_numpy(rng.standard_normal((1, 3, 9, 16, 16)).astype(np.float32))
    z = vae.encode_first_stage(x, window=8)[:, :4]
    frames = vae.decode_first_stage(z, window=2)
    calls = []
    conv = torch.nn.Conv3d.forward
    record = lambda self, inp: (self.kernel_size[0] == 3 and calls.append(inp.shape[2])) or conv(self, inp)  # noqa: E731
    monkeypatch.setattr(torch.nn.Conv3d, "forward", record)
    monkeypatch.setattr(t_vae, "CONV_CHUNK_BYTES", 1)
    z2 = vae.encode_first_stage(x, window=8)[:, :4]
    frames2 = vae.decode_first_stage(z2, window=2)
    assert calls and max(calls) <= 3  # every 3x3x3 conv ran one output frame at a time
    _close(z2.numpy(), z.numpy(), tol=1e-5)
    _close(frames2.numpy(), frames.numpy(), tol=1e-5)


@pytest.mark.parametrize("src,dst", [((1, 3, 3), (1, 6, 6)), ((2, 4, 4), (4, 8, 8)), ((2, 4, 4), (8, 16, 16)),
                                     ((3, 5, 7), (5, 9, 13)), ((2, 3, 3), (3, 7, 5)), ((4, 6, 6), (3, 4, 5))])
def test_nearest_resize_matches_jax_image_resize(rng, src, dst):
    """Half-pixel nearest (``nearest-exact``) is jax.image.resize's "nearest",
    at the decoder's integer ratios and at odd ones; plain "nearest" (floor
    of i * ratio) is not at the odd ones."""
    x = rng.standard_normal((1, 2, *src)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2, *dst), method="nearest"))
    np.testing.assert_array_equal(t_vae._nearest_resize(torch.from_numpy(x), dst).numpy(), want)


def test_spatial_norm_resizes_the_first_frame_alone(rng):
    """An odd frame count: zq's first frame maps to f's first frame only."""
    jvae = _jax_vae(TINY, seed=7)
    tree = jvae.dec_params["params"]["mid_block_1"]["norm1"]
    norm = t_vae.SpatialNorm3D(64, 4)
    norm.load_state_dict(convert.flax_vae_to_state_dict(tree))
    f = rng.standard_normal((1, 64, 5, 8, 8)).astype(np.float32)
    zq = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = j_vae.SpatialNorm3D(64).apply({"params": tree}, jnp.asarray(f).transpose(0, 2, 3, 4, 1),
                                         jnp.asarray(zq).transpose(0, 2, 3, 4, 1), mutable=["cache"])[0]
    with torch.no_grad():
        got = norm(torch.from_numpy(f), torch.from_numpy(zq), {})
    _close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3))


def test_downsample_pads_zero_one(rng):
    """DownSample3D's (0, 1) spatial pad and the causal temporal average, on
    odd sizes, against the flax module."""
    conv = t_vae.DownSample3D(32, 32, compress_time=True)
    params = {"conv": {"kernel": rng.standard_normal((3, 3, 32, 32)).astype(np.float32) / 17,
                       "bias": rng.standard_normal(32).astype(np.float32)}}
    conv.load_state_dict(convert.flax_vae_to_state_dict(params))
    x = rng.standard_normal((1, 32, 5, 9, 7)).astype(np.float32)
    want = j_vae.DownSample3D(32, compress_time=True).apply({"params": params}, jnp.asarray(x).transpose(0, 2, 3, 4, 1))
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert got.shape == (1, 32, 3, 4, 3)
    _close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3), tol=1e-5)


def test_reference_torch_checkpoint_loads_strictly(tmp_path, rng):
    """A torch checkpoint under the reference's keys ({"state_dict": {"encoder.*",
    "decoder.*"}}): the JAX package's loader and the port's read it into the
    same model; the port's halves infer their widths from it."""
    jvae = _jax_vae(FOUR_LEVELS, seed=9)
    sd = {f"{half}.{k}": v for half, tree in (("encoder", jvae.enc_params), ("decoder", jvae.dec_params))
          for k, v in convert.flax_vae_to_state_dict(tree).items()}
    path = tmp_path / "vae.pt"
    torch.save({"state_dict": sd, "global_step": 3}, path)

    enc_tree, dec_tree = j_ae.load_torch_vae_checkpoint(str(path))
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), dec_tree, jvae.dec_params["params"])
    assert all(jax.tree.leaves(same))

    vae = t_ae.VideoAutoencoder.from_torch_checkpoint(str(path), scale_factor=0.5)
    dec = t_ae.VideoAutoencoder.load_decoder(str(path), scale_factor=0.5)
    assert dec.encoder is None and vae.decoder.up[2].block[0].conv1.conv.weight.shape == (64, 64, 3, 3, 3)
    z = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    jvae.scale_factor = 0.5
    want = np.asarray(jvae.decode_first_stage(z, window=2))
    _close(dec.decode_first_stage(torch.from_numpy(z)).numpy(), want)
    _close(vae.decode_first_stage(torch.from_numpy(z)).numpy(), want)
    x = rng.standard_normal((1, 3, 5, 16, 16)).astype(np.float32)
    _close(vae.encode_first_stage(torch.from_numpy(x), window=4).numpy(),
           np.asarray(jvae.encode_first_stage(x, window=4)))

    torch.save({k: v for k, v in sd.items() if not k.startswith("decoder.")}, path)
    with pytest.raises(KeyError, match="decoder"):
        t_ae.VideoAutoencoder.load_decoder(str(path))


def test_published_widths_are_inferred():
    """The CogVideoX VAE 1.0 widths (ch 128, ch_mult (1, 2, 2, 4), 3 res
    blocks, z 16) come back from its tensors' shapes (meta tensors, no data)."""
    with torch.device("meta"):
        full = t_ae.VideoAutoencoder(VaeModelConfig.get_encoder_config(), VaeModelConfig.get_decoder_config())
    assert t_ae._config_of("decoder", full.decoder.state_dict()) == VaeModelConfig.get_decoder_config()
    assert t_ae._config_of("encoder", full.encoder.state_dict()) == VaeModelConfig.get_encoder_config()
    j_keys = {".".join(p.key for p in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                  lambda: j_vae.Decoder3D(JaxVaeConfig.get_decoder_config()).init(
                      jax.random.PRNGKey(0), jnp.zeros((1, 1, 4, 4, 16))))["params"])}
    port = {".".join(j_ae._map_torch_key(k[: k.rfind(".")])) for k in full.decoder.state_dict()}
    assert port == {k[: k.rfind(".")] for k in j_keys}


@pytest.mark.parametrize("offset", [0.0, 10.0])
def test_group_norm_matches_flax_fast_variance(rng, offset):
    """torch's GroupNorm(32, eps 1e-6) against flax's (E[x^2] - E[x]^2 in
    float32) on an NCTHW map, also with a mean offset of 10 standard
    deviations, where the fast variance starts to cancel."""
    import flax.linen as fnn

    x = (offset + rng.standard_normal((1, 64, 3, 6, 5))).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    norm = t_vae._group_norm(64)
    norm.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias)})
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}},
                                                            jnp.asarray(x).transpose(0, 2, 3, 4, 1))
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(want).transpose(0, 4, 1, 2, 3))
