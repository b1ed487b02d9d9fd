"""The port's sampling entry end to end on the CPU with all three weight flags:
``python -m ttt_video_dit_torch.sample --job.platform cpu`` with a tiny T5
directory (``--eval.t5_model_dir``, d_model = the 5B preset's text_dim
4096), an init_state_dir converted from fabricated HF shards by the
``from_hf`` CLI (``--checkpoint.init_state_dir``) and a tiny 4-level VAE
decoder checkpoint under the reference's torch keys
(``--eval.vae_checkpoint_path``), at the tiny DiT widths.

It writes [4T - 3, 8h, 8w, 3] uint8 frames (.npz here: imageio has no ffmpeg
backend) and the latents; the frames equal the port's VAE applied to the
saved latents, bit for bit, and the JAX package's VideoAutoencoder.decode of
the same latents (its own loader reading the same checkpoint) within
|port - jax| <= 1e-4 max|jax| + 1e-4 |jax| in float32, so within 1 of 255
after the uint8 mapping.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from ttt_video_dit_torch import sample  # noqa: E402
from ttt_video_dit_torch.config.model_config import VaeModelConfig  # noqa: E402
from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder  # noqa: E402
from tests.test_torch_t5 import write_unigram_tokenizer  # noqa: E402
from ttt_video_dit_torch.utils import safetensors  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TINY = ["--job.config_file", "configs/eval/ttt-mlp/3s.toml", "--eval.num_denoising_steps", "2",
        "--guider.num_steps", "2", "--eval.image_height", "64", "--eval.image_width", "64", "--eval.txt_maxlen", "16",
        "--model.latent_height", "4", "--model.latent_width", "4", "--model.model_dim", "128",
        "--model.num_heads", "2", "--model.num_layers", "2"]
VAE = dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=16)


def _t5_dir(root):
    from transformers import T5Config, T5EncoderModel

    d = root / "t5"
    d.mkdir()
    words = ["<pad>", "</s>", "<unk>", "a", "cat", "walks", "through", "kitchen", "blurry", "low", "quality"]
    write_unigram_tokenizer(d, words)
    torch.manual_seed(0)
    T5EncoderModel(T5Config(vocab_size=len(words), d_model=4096, d_kv=8, d_ff=16, num_layers=1, num_heads=2,
                            dropout_rate=0.0, feed_forward_proj="gated-gelu")).save_pretrained(d)
    return d


def _hf_dir(root, cfg):
    """bf16 HF-named DiT tensors at the tiny widths, from a seed."""
    from ttt_video_dit_torch.models.dit import from_hf
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX

    port = CogVideoX(cfg).state_dict()
    g = torch.Generator().manual_seed(1)
    names = list(from_hf._TOP) + [f"transformer_blocks.{i}.{n}.{leaf}" for i in range(cfg.num_layers)
                                  for n in from_hf._BLOCK for leaf in ("weight", "bias")]
    tensors = {}
    for n in names:
        shape = port[from_hf.hf_key(n)].shape
        tensors[n] = (torch.randn(shape, generator=g) * (0.02 if n.endswith("weight") else 0.01)).bfloat16()
        if n.endswith(("norm.weight", "norm_final.weight", "norm_q.weight", "norm_k.weight")):  # LayerNorm scales
            tensors[n] = (1 + tensors[n].float()).bfloat16()
    d = root / "hf"
    d.mkdir()
    safetensors.save_file(tensors, str(d / "diffusion_pytorch_model.safetensors"))
    return d


def _vae_checkpoint(root):
    from ttt_video_dit_torch.models.vae.enc_dec import Decoder3D

    torch.manual_seed(2)
    dec = Decoder3D(VaeModelConfig(**VAE))
    path = root / "vae.pt"
    torch.save({"state_dict": {f"decoder.{k}": v for k, v in dec.state_dict().items()}}, path)
    return path


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    root = tmp_path_factory.mktemp("sample_entry")
    # One thread, as in this process: the same convolution algorithms, so the same frames bit for bit.
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    cfg = sample.model_config(sample.parse_args(TINY))
    hf = _hf_dir(root, cfg)
    conv = subprocess.run([sys.executable, "-m", "ttt_video_dit_torch.models.dit.from_hf", "--hf-dir", str(hf),
                           "--output", str(root / "init"), *TINY], cwd=REPO, env=env, capture_output=True, text=True)
    assert conv.returncode == 0, conv.stderr[-3000:]
    flags = [*TINY, "--eval.input_file", "inputs/example.json", "--eval.output_dir", str(root / "out"),
             "--eval.t5_model_dir", str(_t5_dir(root)), "--checkpoint.init_state_dir", str(root / "init"),
             "--eval.vae_checkpoint_path", str(_vae_checkpoint(root))]
    proc = subprocess.run([sys.executable, "-m", "ttt_video_dit_torch.sample", *flags, "--job.platform", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, flags, proc.stdout


def test_sample_entry_writes_frames_with_all_three_flags(sampled):
    root, _, stdout = sampled
    assert "WARNING" not in stdout and "T5 (bfloat16) encoded 1 storyboards" in stdout
    assert f"weights from {root / 'init'}" in stdout and "VAE decode" in stdout
    frames = np.load(root / "out" / "video_0_0.npz")["frames"]
    latents = np.load(root / "out" / "video_0_0_latents.npy")
    assert latents.shape == (13, 16, 8, 8) and np.isfinite(latents).all()
    assert frames.shape == (4 * 13 - 3, 8 * 8, 8 * 8, 3) and frames.dtype == np.uint8
    assert frames.std() > 0


def test_frames_are_the_vae_of_the_saved_latents(sampled):
    """The written frames == the port's VAE on the saved latents, bit for bit,
    and the JAX VAE (its own reader of the same checkpoint) within 1 of 255."""
    from ttt_video_dit_tpu.config.model_config import VaeModelConfig as JaxVaeConfig
    from ttt_video_dit_tpu.models.vae import autoencoder as j_ae

    root, _, _ = sampled
    frames = np.load(root / "out" / "video_0_0.npz")["frames"]
    latents = np.load(root / "out" / "video_0_0_latents.npy")
    vae = VideoAutoencoder.load_decoder(str(root / "vae.pt"))
    got = vae.decode(torch.from_numpy(latents))
    np.testing.assert_array_equal(sample.frames_to_uint8(got), frames)

    cfg = JaxVaeConfig(**VAE)
    jvae = j_ae.VideoAutoencoder(cfg, cfg)
    _, dec = j_ae.load_torch_vae_checkpoint(str(root / "vae.pt"))
    jvae.dec_params = {"params": dec}
    want = np.asarray(jvae.decode(latents))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    want_u8 = ((np.clip(want, -1, 1) + 1) * 127.5).astype(np.uint8)
    assert int(np.abs(frames.astype(np.int16) - want_u8).max()) <= 1


def test_sample_entry_with_the_flags_needs_gpu_unless_cpu_is_asked_for(sampled, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only behaviour")
    _, flags, _ = sampled
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.main(sample.parse_args(flags))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")])
def test_frames_to_uint8_refuses_non_finite_frames(bad):
    """The clip and the uint8 cast would turn NaN or inf into arbitrary bytes: the entry raises instead."""
    frames = torch.zeros(2, 4, 4, 3)
    assert sample.frames_to_uint8(frames).max() == 127
    frames[1, 2, 3, 0] = bad
    with pytest.raises(ValueError, match="NaN or inf"):
        sample.frames_to_uint8(frames)
