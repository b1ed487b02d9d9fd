"""GPU smoke test of the PyTorch port (ttt_video_dit_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its timing; any failure raises and exits
non-zero, and no result line is printed):

1. device, card name and power limit; build and load the CUDA kernels from
   ttt_video_dit_torch/csrc/ (nvcc, sm_90a, one nvcc per source, all at once).
16. (right after phase 1) the kernel self-test a benchmark runs before it
    times anything, ttt_video_dit_torch/utils/selftest.py:kernel_selftest:
    every kernel against its plain version at small discriminating shapes
    (full/ragged checkpoint-group pairs, 12 local heads, a large eta, three
    ragged attention windows forward and backward, the sampling scans at an
    even and an odd NC, K7 bit for bit), each check on a line of its own with
    its tolerance; the worst check of each kernel, the seconds it took after
    the build, and again warm. Raises when a check fails.
2. each kernel against its plain PyTorch version on the card, at the 3 s
   slices' shapes and at a small ragged shape, with times, the bound the
   card sets for the same work, and the time of one PyTorch call computing
   the same function where there is one: K1 (sampling; also at 3 x 48
   scans and at a large eta, where the state update must move the output),
   K3 (sampling),
   K1-train and K2 (TTT-MLP training forward and backward; also at a
   large eta), K3 with the
   log-sum-exp and K4 (attention backward), K5 (TTT-linear, sampling; also
   at 3 x 48 scans and at a large eta), K5-train and K6 (TTT-linear
   training forward and backward; also at a large eta and at 3 x 48
   scans), K7 (the float32 -> bf16 weight cast, bit-exact).
Then, for each model variant the repo ships (ttt_mlp, then ttt_linear), on
its own 3 s TOMLs:
3. one DiffusionTransformer forward at full width (d3072, 48 heads) and
   2 layers, kernel path against the plain functions, same weights.
4. the sampling entry (ttt_video_dit_torch.sample.main) at 42 layers, 3
   denoise steps; kernel launch counts from exactly that run; finite latents
   of the expected shape.
5. one training loss + backward of a full-width 2-layer DiT (the 3 s train
   config, its remat policy save_seq), kernel path against the plain path
   (the same autograd Functions over the plain versions), same weights and
   draws: relative L2 of the loss and of every parameter's gradient; and the
   kernel path under save_seq against the kernel path under "none".
6. the training entry (ttt_video_dit_torch.train.main) at full width, 4
   layers, 3 steps (ttt_mlp: adapter sft; ttt_linear: qkvo), under the
   TOML's save_seq and again under "none": on the card,
   finite loss and grad norm at every step, every trainable tensor moved
   further than weight decay alone would move it (bar those with an all-zero
   last gradient, named, none of them the TTT state K2/K6 train), and the
   launch counts of the training kernels for the run's policy (K7 included:
   the TOMLs set scan_layers) from exactly that run; seconds per step, peak
   memory, MFU.
Then the serving path (ttt_mlp, its 3 s eval TOML, full width; every
weight file fabricated from a seed under output/chip_smoke_serve/, removed
at the end):
7. T5: the encoder at T5-v1.1-XXL's published widths (d_model 4096, 64
   heads x d_kv 64, d_ff 10240, gated-GELU, 32 buckets / max distance 128,
   24 layers, 32,128 + 2 vocab), seeded bf16 weights, encodes seeded ids
   [2 scenes, 498] twice (positive and negative): ms per encode, peak
   memory, finite output. Then text: a 32,000-piece spiece.model written in
   protobuf's wire format by fabricated_spiece (the card's machine has no
   transformers or protobuf) and a seeded 21-scene storyboard, tokenised by
   the port's tokenizer (ms, no unknown pieces) and encoded by the XXL
   encoder ([21, 458], ms). Then the loader end to end at 2 layers: a
   fabricated directory (config.json + model.safetensors from the port's
   writer + the spiece.model) loaded in bf16 on the card and in float32 on
   the CPU, T5TextEncoder.encode on two scenes' text, within T5_REL_L2_TOL.
8. weights, sampling and VAE: HF-named CogVideoX-5B transformer shards
   (bf16, 2 layers, two shards and an index) converted by the from_hf CLI
   into an init_state_dir; the sampling entry on it for 2 denoise steps,
   decoding with a fabricated full-width VAE 1.0 decoder checkpoint
   (torch.save, decoder.* keys) into [49, 480, 720, 3] uint8 frames (VAE
   seconds and each stage's peak memory; the entry raises on non-finite
   float frames, and the uint8 frames must not be constant); kernel launch
   counts from exactly that run; its latents equal bit for bit to those of
   the same converted state dict built in memory (the entry's build_model
   replaced for that run); decoded on the card and on the CPU with the same
   weights, within VAE_REL_L2_TOL: a 3 x 8 x 8 latent crop (three windows,
   the caches threaded) and the run's first latent frame at full
   resolution (one 480 x 720 frame, the 128-channel level-0 maps).
The entry runs with --eval.t5_model_dir: phase 7's 2-layer T5 and its
tokenizer turn the storyboard's text into embeddings.
Then the real training path (phase_resume; the files under
output/chip_smoke_data/, removed at the end):
9. the training entry on 4 fabricated precomputed samples (posteriors
   [13, 32, 60, 90], text [498, 4096], .npy and torch.save'd .pt files,
   seeded), ttt_mlp 3 s TOML at full width cut to 2 layers: run A takes 3
   steps saving at steps 2 and 3, run B resumes from step 2 and takes step
   3. B's step-3 batch and loss equal A's bit for bit, the sampler states
   are equal, the grad norms and parameters agree within the stated
   tolerances; the loader's seconds a batch against the wait for it, and
   the save and restore seconds and bytes.
17. the Slurm launcher's in-job half (ttt_video_dit_torch/train_submitit.py:
    Trainer; the card's machine has no submitit) in a fabricated one-task
    Slurm environment (SLURM_NTASKS 1, SLURM_PROCID 0, SLURM_LOCALID 0, this
    host's name as the node list): phase 9's samples and model, a checkpoint
    every step. Run A saves steps 1 and 2, computes step 3 and is preempted
    while saving it; the Trainer that A's checkpoint() hands to submitit (a
    stand-in DelayedSubmission) resumes from step 2 and takes step 3 again.
    Its step-3 batch and loss equal A's bit for bit, the sampler states are
    equal, grad norms and parameters are held as in phase 9; both runs go
    through torchrun's branch (NCCL, a group of one, FSDP2).
Then the long-context shapes (9 s and 63 s):
10. K1 and K5 on the full 63 s q/k/v [2, 351,168, 48 x 64] (more than 2^31
    elements; the gate holds eta at 0 but on the last 256 mini-batches, so
    the rows whose offsets pass 2^31 are held to the plain scan of their
    heads' tail), K3 at [42, 18,008, 48, 64] (windows 0 and 41) and
    [6, 18,052, 48, 64], K3-lse and K4 at [3, 18,052, 48, 64], K1-train and
    K2 at the 9 s TTT-MLP training scan (NC 804, CS 64, K 16: the last
    group holds 4 steps) and K5-train and K6 at the 9 s TTT-linear one
    (NC 3,216, CS 16, K 4), each with the 9 s rope tables, each against its
    plain version with phase 2's tolerances (output, checkpoints and every
    gradient), with kernel times. Then the 63 s training shapes (the train
    TOMLs under sequence parallelism run them on each rank's heads): K1-train
    and K2 at NC 5,508, CS 64, K 16 and K5-train and K6 at NC 22,011, CS
    16, K 4, the plain versions (which loop over the mini-batches) on the
    last two checkpoint groups, with eta 0 and a zero output gradient before
    them (check_63s_training); K3-lse and K4 at [21, 18,072, 48, 64], the
    plain versions on windows 0 and 20 x heads 0-1; the slices, the plain
    times, the kernel times and bounds printed.
11. for each variant on its 9 s TOMLs (3 scenes, 37 frames, L = 51,456):
    the 2-layer full-width DiT kernel vs plain (DIT_REL_L2_TOL); the
    sampling entry at 42 layers, 2 denoise steps, from a 3-scene storyboard's
    text (phase 7's tokenizer and XXL weights; the XXL's loader draws them
    from phase 7's seed instead of reading a 9.5 GB file), ttt_mlp also
    decoding with phase 8's VAE (37 latent frames to [145, 480, 720, 3]
    uint8); the training entry at 4 layers, 3 steps, the TOML's qkvo and
    policy none (as phase 6).
12. the sampling entry on configs/eval/ttt-mlp/63s.toml at 42 layers, 2
    denoise steps, random DiT weights, from phase 7's 21-scene storyboard:
    the [parallelism] warning (the TOML asks for tp_sharding 2; the port
    samples on one card), finite [253, 16, 60, 90] latents, s/eval, each
    stage's peak, 84 K1 and 42 K3 launches an eval. No VAE decode
    (scripts/profile_torch_vae.py --frames 253 times the 63 s decode).
Then the multi-GPU path at world size 1 (the card's machine has one card,
and NCCL takes one rank a device):
13. the entries' torchrun branch, taken in-process with RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR and MASTER_PORT set: NCCL on cuda:0, the
    (replica, fsdp, tensor) mesh 1 x 1 x 1, the tensor plan (head-sharded
    DTensor parameters, local shards through parallel/sharded.py) and, in
    training, FSDP2 per layer. The training entry on the ttt_mlp 3 s TOML at
    4 layers, 3 steps under save_seq (phase 6's run): its losses held to
    phase 6's within DIST_LOSS_RTOL (the largest difference printed), the
    launch counts of K1-train, K2, K3-lse, K4 and K7 those of phase 6, s/step
    and peak beside phase 6's; the sampling entry on the 3 s eval TOML at 42
    layers, 3 denoise steps (phase 4's run): latents against phase 4's (the
    largest difference printed, within DIST_LATENT_TOL), K1 and K3 counted,
    s/eval and peak beside phase 4's.
Then the offline data path (files under output/chip_smoke_offline/, removed at
the end):
14. the native reader built with g++ (raises if it does not build); a seeded
    VAE 1.0 checkpoint with both halves; seeded uint8 episodes of 49 (3 s)
    and 193 (12 s, 4 encode windows) frames at 480 x 720 encoded through
    precompute_video.precompute_episode: seconds, frames/s, peak, finite
    [13, 32, 60, 90] and [49, 32, 60, 90] posteriors; the card against the
    CPU on a [49, 64, 96] crop within VAE_REL_L2_TOL / VAE_MAX_TOL; a rerun
    that skips through validate_existing. precompute_text.main with T5-XXL
    (phase 7's tokenizer and seeded weights) on 8 annotations at
    --max-length 493: 32 files, ms a batch; 2 of its "both"-mode embeddings
    against the same weights on the CPU within T5_REL_L2_TOL; phase 8's
    2-layer T5 on 2 annotations at 498 tokens (the length the 3 s train
    TOML's CS 64 tiles). A JSONL of the 3 s posterior with those
    embeddings: 3 batches through the DataModule with the native pool and
    in Python (the reader switched off), bit-equal, seconds a batch each;
    one training step of the
    3 s TOML at 2 layers on them (native reader in use, finite loss, launch
    counts). The VAE with group= an NCCL group of one: bit-equal to the
    one-device encode (a no-op check: a group of one runs the one-device
    code, and parallel/spatial.py's split runs only at two ranks or more,
    scripts/check_torch_vae_split.py).
Then the longest training stage one card holds:
15. the training entry on the ttt_mlp 30 s train TOML (L = 168,640: 10
    scenes of 529 synthetic text tokens and 121 frames; NC 2,635 at CS 64,
    K 16; remat policy none, scan_layers) at 2 layers, 2 steps: the TOML's
    shard_transformer_inputs and tp_sharding 2 ask for two tensor ranks, so
    it runs train_toml's one-card copy (both off, every other line the
    TOML's). Finite losses, every trained tensor moved, launch counts,
    s/step, MFU and peak. A 63 s layer does not fit one card (its backward
    keeps ~43 times the 2.02 GiB bf16 stream); the 63 s TOMLs and the
    sequence-parallel layout itself, which runs only at a tensor group of
    two or more, are scripts/check_torch_sequence_parallel.py's, on 2 and 4
    cards.

The second-to-last line is the kernels' JSON record (launches: the sum over
the main-path runs of phases 4, 6 (both policies), 8, 9, 17, 11, 12, 13, 14 and 15); the last line is
{"ok": true, "device": {...}}. Float32 matmuls run without TF32 here so the
plain versions are exact float32 references (the VAE turns cuDNN's TF32 off
itself).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ("ttt_mlp", "ttt_linear")


def sample_args(variant: str) -> list[str]:
    return ["--job.config_file", f"configs/eval/{variant.replace('_', '-')}/3s.toml", "--eval.input_file",
            "inputs/example.json", "--eval.num_denoising_steps", "3", "--guider.num_steps", "3"]


def long_sample_args(variant: str, length: str) -> list[str]:
    """The sampling entry's flags for a variant's eval TOML of ``length`` (9s, 63s), 2 denoise steps."""
    return ["--job.config_file", f"configs/eval/{variant.replace('_', '-')}/{length}.toml",
            "--eval.num_denoising_steps", "2", "--guider.num_steps", "2"]


def one_card_toml(path: str, out: str) -> str:
    """The TOML at ``path`` (from the repo's root) as one card runs it: ``tp_sharding`` 1 and ``[remat]
    shard_transformer_inputs`` false (the 30 s and 63 s train TOMLs set it, and, as in the JAX package, it asks for
    a tensor axis of more than one rank), every other line the TOML's. ``path`` itself where both already hold,
    else a copy written under ``out``."""
    with open(os.path.join(ROOT, path), encoding="utf-8") as f:
        text = f.read()
    one = text.replace("\nshard_transformer_inputs = true", "\nshard_transformer_inputs = false")
    if "\ntp_sharding = 1\n" not in one:
        one = one.replace("\ntp_sharding = ", "\ntp_sharding = 1\n# the TOML's tp_sharding = ")
    if one == text:
        return path
    os.makedirs(out, exist_ok=True)
    dst = os.path.join(out, path.replace("/", "_"))
    with open(dst, "w", encoding="utf-8") as f:
        f.write(one)
    return dst


def train_toml(variant: str, length: str) -> str:
    """The variant's train TOML of ``length``, as one card runs it (one_card_toml)."""
    return one_card_toml(f"configs/train/{variant.replace('_', '-')}/{length}.toml", "output")


def train_args(variant: str, length: str = "3s", layers: int = 4, steps: int = 3) -> list[str]:
    return ["--job.config_file", train_toml(variant, length), "--model.num_layers", str(layers),
            "--training.steps", str(steps), "--training.global_batch_size", "1", "--training.grad_accum_steps", "1",
            "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1"]


KERNELS = ("attention_forward", "attention_backward", "ttt_mlp_forward", "ttt_mlp_backward", "ttt_linear_forward",
           "ttt_linear_backward", "convert")
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise, on bf16 outputs. The
# kernels round at the plain versions' points; what remains is float32
# summation order (and, for attention, P and dS rounded to bf16 as operands),
# i.e. a few bf16 ulps of outputs of magnitude up to ~5.
KERNEL_TOL = {"ttt_mlp_forward": (2e-2, 2e-2), "attention_forward": (2e-2, 2e-2), "ttt_mlp_forward_train": (2e-2, 2e-2),
              "attention_forward_lse": (2e-2, 2e-2), "attention_backward": (2e-2, 2e-2),
              "ttt_mlp_backward": (2e-2, 2e-2), "ttt_linear_forward": (2e-2, 2e-2),
              "ttt_linear_forward_train": (2e-2, 2e-2), "ttt_linear_backward": (2e-2, 2e-2)}
# The float32 outputs of the training kernels (K1-train's and K5-train's
# state checkpoints, K2's and K6's gradients), each held by its relative L2
# error, ||kernel - plain|| / ||plain|| <= REL_L2_TOL, and by its largest
# error, max|kernel - plain| <= SCALED_TOL * max|plain|. The checkpoints carry
# the forward's bf16 rounding flips into fp32 sums; the backwards' weight,
# bias and LN gradients carry them through the second-order step VJP and span
# five orders of magnitude, so no one elementwise tolerance fits them. Their
# input gradients (dXQ, dXK, dXV, d_gate) are held elementwise as well, by
# KERNEL_TOL. K7 must be bit-exact.
REL_L2_TOL = 1e-2
SCALED_TOL = {"ttt_mlp_forward_train": 1e-3, "ttt_mlp_backward": 1e-2, "ttt_linear_forward_train": 1e-3,
              "ttt_linear_backward": 1e-2}
ELEMENTWISE_GRADS = ("dXQ", "dXK", "dXV", "d_gate")
# The TTT layer's parameters whose gradients K2 (ttt_mlp: all six) or K6
# (ttt_linear: W1, b1 and the TTT norm) writes: a training step must move
# each of them.
TTT_STATE_PARAMETERS = (".W1", ".b1", ".W2", ".b2", ".ttt_norm_weight", ".ttt_norm_bias")
# A trained tensor must move more than this many times as far as weight decay
# alone would have moved it over the run.
DECAY_MARGIN = 10.0
LSE_ATOL = 1e-4  # the log-sum-exp is float32 of values up to ~11
# K1's large-eta case: the plain output must lie at least this many
# tolerances from the eta = 0 output, or the case could not see a wrong
# state update.
MOVED_TOLS = 10
# The training checks' large eta, as a multiple of the slice's: ttt_mlp 4,096 x 0.1 / 64 / 64 = 0.1, ttt_linear
# 100 x 1.0 / 64 / 16 = 0.098 (the sampling checks take 1,000x the slice's: 0.098 and 0.98).
LARGE_ETA_FACTOR = {"ttt_mlp": 4096, "ttt_linear": 100}
# Relative L2 error of the 2-layer DiT output, kernel path vs plain path: the
# bf16 stream carries the kernels' rounding differences through two layers.
DIT_REL_L2_TOL = 2e-2
# Relative L2 error of the 2-layer training loss and of each parameter's
# gradient, kernel path vs plain path: the forward's 3e-3 (phase 3) carried
# back through two layers of bf16 backward.
GRAD_REL_L2_TOL = {"loss": 1e-2, "grad": 5e-2}
# Phase 9: the step-3 grad norm after a resume against the uninterrupted run's (K4's dq order only).
RESUME_GRAD_NORM_RTOL = 1e-3
# H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s and dense bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# T5-v1.1-XXL's published widths (its config.json), and the 2 scene tokens' rows.
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64,
              relative_attention_num_buckets=32, relative_attention_max_distance=128, feed_forward_proj="gated-gelu")
T5_SCENE_VOCAB = 32128 + 2
# Relative L2 error of the 2-layer T5 in bf16 on the card against float32 on
# the CPU, same (bf16-exact) weights and ids: the bf16 activations' rounding,
# ~6e-3 at 2 layers at T5's own initialisation (measured on the CPU at d_model
# 512 and 1024).
T5_REL_L2_TOL = 2e-2
# The VAE decodes in float32 with cuDNN's TF32 off, so the card differs from
# the CPU by summation order and by the algorithms cuDNN picks (Winograd or FFT
# round float32 differently from direct sums): relative L2 <= VAE_REL_L2_TOL
# and max|card - cpu| <= VAE_MAX_TOL * max|cpu|.
VAE_REL_L2_TOL = 1e-4
VAE_MAX_TOL = 1e-3
# Phase 13 against phases 6 and 4, the same runs through the torchrun branch at world size 1: the arithmetic
# is the same (every collective of a group of one is skipped or a copy), but K4 adds dq by float32
# reduce-adds whose order varies between runs, so the losses after the first update may differ in their
# last bits (as phase 9's resumed grad norm); sampling runs no K4, and its latents must be bit-equal.
DIST_LOSS_RTOL = 1e-3
DIST_LATENT_TOL = 0.0
SERVE_DIR = "output/chip_smoke_serve"
TRAIN_DIR = "output/chip_smoke_train"  # phase 6's logs
DATA_DIR = "output/chip_smoke_data"  # phase 9's fabricated dataset, logs and checkpoints
CARD = ""  # the card's name and power limit, as nvidia-smi prints them; set by main()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_clocks(when: str) -> None:
    """The card's SM clock (and its maximum), power draw and temperature, so
    that times from different calls can be read against the clocks they ran at."""
    query = "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader"], capture_output=True, text=True)
    log(f"  clocks {when}: {(out.stdout or out.stderr).strip()}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), milliseconds of that one run by CUDA events): for the plain versions, slow enough to run once."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def compare(name: str, got, want, what: str = "") -> float:
    atol, rtol = KERNEL_TOL[name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {what}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name} {what}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
                             f"max_abs_err={float(err.max()):.4g}")
    return float(err.max())


def compare_scaled(name: str, what: str, got, want) -> tuple[float, float]:
    """Max abs error and relative L2 error of a float32 training-kernel output."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {what}: kernel output has non-finite values")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    rel = float((got - want).norm() / want.norm())
    if not rel <= REL_L2_TOL:
        raise AssertionError(f"{name} {what}: relative L2 error {rel:.4g} > {REL_L2_TOL}")
    if err > SCALED_TOL[name] * scale:
        raise AssertionError(f"{name} {what}: max_abs_err {err:.4g} > {SCALED_TOL[name]} x max|plain| {scale:.4g}")
    return err, rel


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take: max(bytes / HBM rate, flops / bf16 peak)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(name, source, replaces, err, ms, plain_ms, nbytes, flops, library_ms=None) -> dict:
    bound_ms, bound_by = bound(nbytes, flops)
    library = "n/a" if library_ms is None else f"{library_ms:.3f} ms (kernel / library {ms / library_ms:.2f}x)"
    log(f"  {name} slice: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"library {library}, max_abs_err {err:.4g}")
    return dict(name=name, route="cuda", source=f"ttt_video_dit_torch/csrc/{source}", replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_build():
    from ttt_video_dit_torch.ops import _build, attention, convert, ttt_linear_kernel, ttt_mlp_kernel

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(_build.load, KERNELS))
    for lib in (ttt_mlp_kernel._lib(), ttt_mlp_kernel._lib("ttt_mlp_backward"), attention._lib(),
                attention._lib("attention_backward"), ttt_linear_kernel._lib(),
                ttt_linear_kernel._lib("ttt_linear_backward"), convert._lib()):
        assert lib is not None
    for name, info in _build.build_info.items():
        usage = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: built in {info['seconds']:.1f} s; ptxas: {' | '.join(usage)}")
    fwd = _build.load("ttt_mlp_forward")
    smem = {"ttt_mlp_forward": fwd.ttt_mlp_forward_smem_bytes(),
            "ttt_mlp_forward_train": fwd.ttt_mlp_forward_train_smem_bytes(),
            "ttt_mlp_backward": _build.load("ttt_mlp_backward").ttt_mlp_backward_smem_bytes(),
            "ttt_linear_forward": _build.load("ttt_linear_forward").ttt_linear_forward_smem_bytes(),
            "ttt_linear_backward": _build.load("ttt_linear_backward").ttt_linear_backward_smem_bytes()}
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s (dynamic shared memory: "
        + ", ".join(f"{k} {v} bytes" for k, v in smem.items()) + ")")


def phase_selftest(device) -> None:
    """Phase 16 (right after phase 1): utils/selftest.py:kernel_selftest, every kernel against its plain version
    at small discriminating shapes, each check on a line of its own; then once more, for its time warm. Raises
    when a check fails."""
    from ttt_video_dit_torch.utils.selftest import kernel_selftest

    result = kernel_selftest(device, log=log)
    failed = [n for n, e in result["checks"].items() if not e <= result["tolerances"][n]]
    if failed:
        raise AssertionError(f"kernel self-test: {len(failed)} checks failed: {failed}")
    warm = kernel_selftest(device)
    if not warm["ok"]:
        raise AssertionError(f"kernel self-test, second run: {warm['checks']}")
    worst = {}  # row: (check, error, tolerance) of the check nearest its tolerance
    for name, err in result["checks"].items():
        row, tol = name[name.rindex("[") + 1 : -1], result["tolerances"][name]
        share = err / tol if tol else float(err > 0)
        if row not in worst or share > worst[row][0]:
            worst[row] = (share, name[: name.rindex("[") - 1], err, tol)
    log(f"phase 16 kernel self-test: {len(result['checks'])} checks within their tolerances; worst per kernel: "
        + ", ".join(f"{row} {n} {e:.3g} (tol {t:.0e})" for row, (_, n, e, t) in worst.items())
        + f"; {result['seconds']:.2f} s (first run, after the build), {warm['seconds']:.2f} s (second) ({CARD})")


def _ttt_inputs(B, H, NC, gen, device, meta=None, CS=16, variant="ttt_mlp"):
    from ttt_video_dit_torch.models.ttt.layer import scan_rope_tables

    F = 64
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=device) * std
    x = lambda: randn(B, NC, CS, H * F).to(torch.bfloat16)
    if meta is None:
        angles = torch.rand(NC, CS, F // 2, generator=gen, device=device) * 6.3
        cos, sin = (t.repeat_interleave(2, dim=-1).contiguous() for t in (torch.cos(angles), torch.sin(angles)))
    else:
        cos, sin = scan_rope_tables(meta, F, 10000.0, CS, device)
    a = dict(XQ=x(), XK=x(), XV=x(), gate=randn(B, H, NC, CS), rope_cos=cos, rope_sin=sin,
             ln_w=1.0 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1))
    if variant == "ttt_linear":
        return dict(a, W1=randn(H, F, F, std=0.02), b1=randn(H, 1, F, std=0.02))
    return dict(a, W1=randn(H, F, 4 * F, std=0.02), b1=randn(H, 1, 4 * F, std=0.02),
                W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02))


# Per variant: the state's names, the fp32 floats of one head's state, and the TPU kernels it replaces
# (forward, backward). ttt_mlp: W1 [F, 4F], b1 [4F], W2 [4F, F], b2 [F]; ttt_linear: W1 [F, F], b1 [F].
TTT = {
    "ttt_mlp": (("W1", "b1", "W2", "b2"), lambda F: 8 * F * F + 5 * F,
                ("ops/pallas/ttt_forward.py:247", "ops/pallas/ttt_backward.py:165")),
    "ttt_linear": (("W1", "b1"), lambda F: F * F + F,
                   ("ops/pallas/ttt_forward.py:187", "ops/pallas/ttt_backward.py:431")),
}
TPU = "ttt_video_dit_tpu/"
SEQ = 18048  # tokens of the 3 s shape: 498 text + 13 frames x 30 x 45


def _ttt_bytes(variant, B, H, NC, CS, F=64, bf16_tensors=4):
    """Bytes a TTT scan must move once: ``bf16_tensors`` token-major bf16
    tensors (q/k/v and the output), f32 gate, rope tables, LN affine and the
    variant's initial state."""
    L = NC * CS
    return bf16_tensors * B * L * H * F * 2 + B * H * L * 4 + 2 * L * F * 4 + 2 * H * F * 4 + H * TTT[variant][1](F) * 4


def _ttt_flops_per_step(variant, CS, F=64):
    """Matmul FLOPs of one dual-form step of one (batch, head). ttt_mlp
    (utils/metrics.py's count): 7 F x 4F products and the CS x CS mixing.
    ttt_linear: Z1 = XK W, XQ W and the update XK^T G (F x F), attn and
    attn @ G (CS x CS)."""
    if variant == "ttt_linear":
        return 6 * CS * F * F + 4 * CS * CS * F
    return 56 * CS * F * F + 20 * CS * CS * F


def _ttt_bwd_flops_per_step(variant, CS, F=64):
    """The operations the backward (the forward's VJP from its checkpoints)
    needs a step and head: the forward step once and its VJP; each kernel's
    re-run of the state update in pass A is its own choice and not counted.
    ttt_mlp (K2): 40 CS F^2 to advance the state, 16 CS F^2 + 20 CS^2 F for
    the output, VJP 112 CS F^2 + 40 CS^2 F. ttt_linear (K6): 6 CS F^2 +
    4 CS^2 F, VJP ten products (dZb1 W^T, XQ^T dZb1, dZb1 Gs^T, A1^T dZb1,
    Gs dW^T, XK dW, dA1 XK, dA1^T XQ, dZ1 W^T, XK^T dZ1) 12 CS F^2 + 8 CS^2 F."""
    if variant == "ttt_linear":
        return 18 * CS * F * F + 12 * CS * CS * F
    return 168 * CS * F * F + 60 * CS * CS * F


def _ttt_module(variant):
    from ttt_video_dit_torch.ops import ttt_linear_kernel, ttt_mlp_kernel

    return ttt_linear_kernel if variant == "ttt_linear" else ttt_mlp_kernel


def _sampling_meta(variant):
    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata

    cfg = sample.model_config(sample.parse_args(sample_args(variant)))
    return cfg, sequence_metadata(cfg, num_frames=13, latent_height=60, latent_width=90, num_scenes=1,
                                  text_length=498)


def _training_meta(variant, length: str = "3s"):
    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata

    cfg = train.model_config(train.parse_args(train_args(variant, length)))
    return cfg, sequence_metadata(cfg, num_frames=cfg.compressed_num_frames, latent_height=60, latent_width=90,
                                  num_scenes=cfg.num_chunks, text_length=train.synthetic_text_length(cfg))


def in_tolerances(name: str, a, b) -> float:
    """max |a - b| / (ATOL + RTOL |b|), elementwise: how many of the kernel's tolerances apart."""
    atol, rtol = KERNEL_TOL[name]
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


def check_ttt_forward(variant, gen, device) -> dict:
    """K1 or K5 at the sampling slice (B=2 CFG, 48 heads, NC=1128 at CS=16, the 3 s tables), ragged, at 3 x 48
    scans (more blocks than SMs) and at an eta 1,000x the slice's, where the plain output must move at least
    MOVED_TOLS tolerances away from the eta = 0 output (so a wrong state update cannot hide)."""
    mod, name = _ttt_module(variant), f"{variant}_forward"
    kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    cfg, meta = _sampling_meta(variant)
    CS = cfg.mini_batch_size
    eta_scale = cfg.ttt_base_lr / 64 / CS
    cases = [(2, 48, SEQ // CS, meta, eta_scale), (1, 2, 7, None, eta_scale), (3, 48, 4, None, eta_scale),
             (1, 2, 17, None, 1000 * eta_scale)]
    for i, (B, H, NC, m, eta) in enumerate(cases):
        # ttt_linear's cases after the first two draw from their own generators, so the caller's generator, and
        # with it the inputs of the kernels checked after these, advance as they did without them.
        g = torch.Generator(device).manual_seed(6 + i) if variant == "ttt_linear" and i >= 2 else gen
        a = _ttt_inputs(B, H, NC, g, device, m, CS=CS, variant=variant)
        got = kernel(**a, eta_scale=eta)
        want, plain_ms = timed(lambda: plain(**a, eta_scale=eta))
        err = compare(name, got, want)
        moved = ""
        if eta != eta_scale:
            tols = in_tolerances(name, want, plain(**a, eta_scale=0.0))
            if tols < MOVED_TOLS:
                raise AssertionError(f"{name} eta_scale={eta:.4g}: the plain output moved only {tols:.3g} "
                                     f"tolerances from the eta = 0 output (at least {MOVED_TOLS} needed)")
            moved = f"; the plain output {tols:.1f} tolerances from eta = 0's"
        log(f"  {name} B={B} H={H} NC={NC} eta_scale={eta:.4g}: max_abs_err {err:.4g} (tol {KERNEL_TOL[name]}){moved}")
        if m is not None:
            sl = dict(a=a, err=err, plain_ms=plain_ms, NC=NC)
    ms = cuda_ms(lambda: kernel(**sl["a"], eta_scale=eta_scale), 5)
    return record(name, f"{name}.cu", TPU + TTT[variant][2][0], sl["err"], ms, sl["plain_ms"],
                  _ttt_bytes(variant, 2, 48, sl["NC"], CS), 2 * 48 * sl["NC"] * _ttt_flops_per_step(variant, CS))


def _check_training_case(variant, B, H, NC, K, meta, eta, eta_scale, CS, gen, device) -> dict:
    """K1-train and K2, or K5-train and K6, against their plain versions on one case: the output elementwise, the
    checkpoints and every gradient in relative L2 (dXQ, dXK, dXV and d_gate also elementwise); at an ``eta`` other
    than ``eta_scale`` the plain output must lie MOVED_TOLS tolerances from the eta = 0 output. Returns the inputs,
    checkpoints, output gradient, errors and plain times."""
    mod = _ttt_module(variant)
    fwd, bwd = f"{variant}_forward_train", f"{variant}_backward"
    fwd_k, bwd_k = getattr(mod, fwd), getattr(mod, bwd)
    fwd_p, bwd_p = getattr(mod, f"{variant}_forward_plain"), getattr(mod, f"{variant}_backward_plain")
    state = TTT[variant][0]
    names = tuple(f"{n}_ck" for n in state)
    gnames = ELEMENTWISE_GRADS + tuple(f"d{n}" for n in state) + ("dln_w", "dln_b")
    a = _ttt_inputs(B, H, NC, gen, device, meta, CS=CS, variant=variant)
    got = fwd_k(**a, eta_scale=eta, checkpoint_group=K)
    want, fwd_plain_ms = timed(lambda: fwd_p(**a, eta_scale=eta, checkpoint_group=K))
    out_err = compare(fwd, got[0], want[0])
    errs = [compare_scaled(fwd, n, g, w) for n, g, w in zip(names, got[1:], want[1:])]
    del got
    moved = ""
    if eta != eta_scale:
        tols = in_tolerances(fwd, want[0], fwd_p(**a, eta_scale=0.0))
        if tols < MOVED_TOLS:
            raise AssertionError(f"{fwd} eta_scale={eta:.4g}: the plain output moved only {tols:.3g} "
                                 f"tolerances from the eta = 0 output (at least {MOVED_TOLS} needed)")
        moved = f"; the plain output {tols:.1f} tolerances from eta = 0's"
    log(f"  {fwd} B={B} H={H} NC={NC} K={K} eta_scale={eta:.4g}: out max_abs_err {out_err:.4g}; checkpoints "
        "max_abs_err / rel L2 " + ", ".join(f"{n} {e:.4g} / {r:.3g}" for n, (e, r) in zip(names, errs)) + moved)
    dout = torch.randn(*a["XQ"].shape, generator=gen, device=device).bfloat16()
    ins = [a[n] for n in TRAIN_INPUTS]
    gk = bwd_k(*ins, *want[1:], dout, eta, K)
    gp, bwd_plain_ms = timed(lambda: bwd_p(*ins, *want[1:], dout, eta, K))
    gerrs = [compare_scaled(bwd, n, g, w) for n, g, w in zip(gnames, gk, gp)]
    log(f"  {bwd} B={B} H={H} NC={NC} K={K} eta_scale={eta:.4g}: max_abs_err / rel L2 "
        + ", ".join(f"{n} {e:.4g} / {r:.3g}" for n, (e, r) in zip(gnames, gerrs))
        + f" (tol rel L2 {REL_L2_TOL}; {', '.join(ELEMENTWISE_GRADS)} also elementwise {KERNEL_TOL[bwd]})")
    for n, g, w in zip(gnames, gk, gp):
        if n in ELEMENTWISE_GRADS:
            compare(bwd, g, w, n)
    return dict(a=a, ck=want[1:], dout=dout, err=out_err, gerr=max(e for e, _ in gerrs), NC=NC,
                fwd_plain_ms=fwd_plain_ms, bwd_plain_ms=bwd_plain_ms)


TRAIN_INPUTS = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")  # the backward's leading arguments


def _training_cost(variant, NC, K, CS) -> tuple[float, float, float, float]:
    """(forward bytes, forward operations, backward bytes, backward operations) of the training scans of one
    48-head batch row. Backward bytes: q/k/v and dout in, dXQ/dXK/dXV out (bf16), the gate in and d_gate out, the
    tables, LN affine, checkpoints and initial-state-sized gradients."""
    ck_bytes = -(-NC // K) * 48 * TTT[variant][1](64) * 4
    return (_ttt_bytes(variant, 1, 48, NC, CS) + ck_bytes, 48 * NC * _ttt_flops_per_step(variant, CS),
            _ttt_bytes(variant, 1, 48, NC, CS, bf16_tensors=7) + ck_bytes + NC * CS * 48 * 4,
            48 * NC * _ttt_bwd_flops_per_step(variant, CS))


def check_ttt_training(variant, gen, device) -> list[dict]:
    """K1-train and K2, or K5-train and K6, at the training slice (B=1, 48
    heads, the TOML's CS and K: ttt_mlp NC=282 at CS=64, K=16, last group 10;
    ttt_linear NC=1128 at CS=16, K=4; the 3 s training tables) and at a
    small ragged shape (NC=7, K=3: the last group has one step), also at a
    large eta (LARGE_ETA_FACTOR x the slice's), where the plain output must
    lie MOVED_TOLS tolerances from the eta = 0 output; K5-train and K6 also
    at 3 x 48 scans (more blocks than SMs)."""
    mod = _ttt_module(variant)
    fwd, bwd = f"{variant}_forward_train", f"{variant}_backward"
    fwd_k, bwd_k = getattr(mod, fwd), getattr(mod, bwd)
    cfg, meta = _training_meta(variant)
    K, CS = cfg.scan_checkpoint_group_size, cfg.mini_batch_size
    eta_scale = cfg.ttt_base_lr / 64 / CS
    cases = [(1, 48, SEQ // CS, K, meta, eta_scale), (1, 2, 7, 3, None, eta_scale),
             (1, 2, 7, 3, None, LARGE_ETA_FACTOR[variant] * eta_scale)]
    if variant == "ttt_linear":
        cases.append((3, 48, 4, 3, None, eta_scale))
    for i, (B, H, NC, KK, m, eta) in enumerate(cases):
        # The cases after the first two draw from their own generators, so the caller's generator, and with it
        # the inputs of the kernels checked after these, advance as they did without them.
        if i >= 2:
            gen = torch.Generator(device).manual_seed(5 + 2 * (i - 2))
        r = _check_training_case(variant, B, H, NC, KK, m, eta, eta_scale, CS, gen, device)
        if m is not None:
            sl = r
    a, ck, dout, NC = sl["a"], sl["ck"], sl["dout"], sl["NC"]
    ins = [a[n] for n in TRAIN_INPUTS]
    fwd_ms = cuda_ms(lambda: fwd_k(**a, eta_scale=eta_scale, checkpoint_group=K), 3)
    bwd_ms = cuda_ms(lambda: bwd_k(*ins, *ck, dout, eta_scale, K), 3)
    fb, ff, bb, bf = _training_cost(variant, NC, K, CS)
    return [record(fwd, f"{variant}_forward.cu", TPU + TTT[variant][2][0], sl["err"], fwd_ms, sl["fwd_plain_ms"],
                   fb, ff),
            record(bwd, f"{variant}_backward.cu", TPU + TTT[variant][2][1], sl["gerr"], bwd_ms, sl["bwd_plain_ms"],
                   bb, bf)]


def check_long_training(variant, gen, device) -> None:
    """K1-train and K2, or K5-train and K6, at the 9 s training shape (B=1, 48 heads, the 9 s train TOML's CS and
    K and its rope tables: ttt_mlp NC=804 at CS=64, K=16, last group 4; ttt_linear NC=3,216 at CS=16, K=4) against
    their plain versions with phase 2's tolerances; kernel times against their bounds."""
    mod = _ttt_module(variant)
    fwd_k, bwd_k = getattr(mod, f"{variant}_forward_train"), getattr(mod, f"{variant}_backward")
    cfg, meta = _training_meta(variant, "9s")
    K, CS = cfg.scan_checkpoint_group_size, cfg.mini_batch_size
    NC = (meta.seq_text_length + meta.num_video_tokens) // CS
    eta_scale = cfg.ttt_base_lr / 64 / CS
    r = _check_training_case(variant, 1, 48, NC, K, meta, eta_scale, eta_scale, CS, gen, device)
    a, ck, dout = r["a"], r["ck"], r["dout"]
    ins = [a[n] for n in TRAIN_INPUTS]
    fwd_ms = cuda_ms(lambda: fwd_k(**a, eta_scale=eta_scale, checkpoint_group=K), 2)
    bwd_ms = cuda_ms(lambda: bwd_k(*ins, *ck, dout, eta_scale, K), 2)
    fb, ff, bb, bf = _training_cost(variant, NC, K, CS)
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = bound(fb, ff), bound(bb, bf)
    log(f"    kernels at NC {NC}, K {K} (last group {NC - (-(-NC // K) - 1) * K}): {variant}_forward_train "
        f"{fwd_ms:.3f} ms (bound {fwd_bound:.3f} ms, {fwd_by}; plain {r['fwd_plain_ms']:.1f}), {variant}_backward "
        f"{bwd_ms:.3f} ms (bound {bwd_bound:.3f} ms, {bwd_by}; plain {r['bwd_plain_ms']:.1f})")


def check_63s_training(variant, gen, device) -> None:
    """K1-train and K2, or K5-train and K6, at the 63 s train TOML's scan (B=1, 48 heads, its CS, K and rope
    tables: ttt_mlp NC 5,508 at CS 64, K 16, last group 4; ttt_linear NC 22,011 at CS 16, K 4, last group 3). The
    plain versions loop over the mini-batches, so they are held to the kernels on a slice of them: the gate is
    -1e4 (eta 0: the state stays the initial one) but on the last two checkpoint groups, and the output gradient
    is 0 but there. Then the kernels' output and checkpoints on that tail equal the plain scan of the tail alone
    from the initial state, their checkpoints before it the initial state, their output on the first 64
    mini-batches the plain scan of those, every gradient the plain backward of the tail alone, and the input
    gradients before the tail 0; phase 2's tolerances. Kernel times over the whole scan against their bounds."""
    mod = _ttt_module(variant)
    fwd, bwd = f"{variant}_forward_train", f"{variant}_backward"
    fwd_k, bwd_k = getattr(mod, fwd), getattr(mod, bwd)
    fwd_p, bwd_p = getattr(mod, f"{variant}_forward_plain"), getattr(mod, f"{variant}_backward_plain")
    cfg, meta = _training_meta(variant, "63s")
    K, CS, H = cfg.scan_checkpoint_group_size, cfg.mini_batch_size, 48
    NC = (meta.seq_text_length + meta.num_video_tokens) // CS
    NG = -(-NC // K)
    tail0 = (NG - 2) * K  # the last two groups
    eta = cfg.ttt_base_lr / 64 / CS
    state = TTT[variant][0]
    a = _ttt_inputs(1, H, NC, gen, device, meta, CS=CS, variant=variant)
    a["gate"][:, :, :tail0] = -1e4
    got = fwd_k(**a, eta_scale=eta, checkpoint_group=K)
    tail = _scan_slice(a, 0, slice(0, H), slice(tail0, NC))
    want, fwd_plain_ms = timed(lambda: fwd_p(**tail, eta_scale=eta, checkpoint_group=K))
    errs = [compare(fwd, got[0][:, tail0:], want[0], "the tail")]
    errs.append(compare(fwd, got[0][:, :64], fwd_p(**_scan_slice(a, 0, slice(0, H), slice(0, 64)), eta_scale=eta,
                                                  checkpoint_group=K)[0], "mini-batches 0-63 at eta 0"))
    for n, g, w in zip(state, got[1:], want[1:]):
        compare_scaled(fwd, f"{n}_ck on the tail", g[:, :, NG - 2 :], w)
        compare_scaled(fwd, f"{n}_ck before the tail", g[:, :, : NG - 2], a[n][None, :, None].expand_as(g[:, :, : NG - 2]))
    dout = torch.zeros_like(a["XQ"])
    dout[:, tail0:] = torch.randn(*dout[:, tail0:].shape, generator=gen, device=device).bfloat16()
    ins = [a[n] for n in TRAIN_INPUTS]
    gk = bwd_k(*ins, *got[1:], dout, eta, K)
    gp, bwd_plain_ms = timed(lambda: bwd_p(*[tail[n] for n in TRAIN_INPUTS], *want[1:], dout[:, tail0:], eta, K))
    gnames = ELEMENTWISE_GRADS + tuple(f"d{n}" for n in state) + ("dln_w", "dln_b")
    gerr = 0.0
    for n, g, w in zip(gnames, gk, gp):
        if n in ELEMENTWISE_GRADS:
            at = (slice(None), slice(None), slice(tail0, None)) if n == "d_gate" else (slice(None), slice(tail0, None))
            before = (slice(None), slice(None), slice(0, tail0)) if n == "d_gate" else (slice(None), slice(0, tail0))
            gerr = max(gerr, compare(bwd, g[at], w, f"{n} on the tail"))
            compare(bwd, g[before], torch.zeros_like(g[before]), f"{n} before the tail")
        else:
            gerr = max(gerr, compare_scaled(bwd, n, g, w)[0])
    del got, gk, gp
    fwd_ms = cuda_ms(lambda: fwd_k(**a, eta_scale=eta, checkpoint_group=K), 2)
    ck = fwd_k(**a, eta_scale=eta, checkpoint_group=K)[1:]
    bwd_ms = cuda_ms(lambda: bwd_k(*ins, *ck, dout, eta, K), 2)
    fb, ff, bb, bf = _training_cost(variant, NC, K, CS)
    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = bound(fb, ff), bound(bb, bf)
    log(f"  {fwd} / {bwd} at the 63 s train scan, B 1, {H} heads, NC {NC} at CS {CS}, K {K} (last group "
        f"{NC - (NG - 1) * K}): output max_abs_err {max(errs):.4g}, gradients {gerr:.4g} (tol {KERNEL_TOL[fwd]}; "
        f"checkpoints and state gradients rel L2 {REL_L2_TOL}); the plain versions on mini-batches {tail0}-{NC - 1} "
        f"of all {H} heads (the tail), forward {fwd_plain_ms:.1f} ms, backward {bwd_plain_ms:.1f} ms; kernels over "
        f"all {NC}: {fwd} {fwd_ms:.3f} ms (bound {fwd_bound:.3f} ms, {fwd_by}), {bwd} {bwd_ms:.3f} ms (bound "
        f"{bwd_bound:.3f} ms, {bwd_by})")
    del a, ck, dout, ins


def check_63s_attention(gen, device, windows=(0, 20), heads=slice(0, 2)) -> None:
    """K3-lse and K4 at the 63 s TTT-MLP train TOML's windows [21, 18,072, 48, 64] against their plain versions
    on ``windows`` x ``heads`` (attention is independent per window and head), with kernel times over all."""
    from ttt_video_dit_torch.ops import attention

    shape = (21, S_63S_TRAIN, 48, 64)
    q, k, v, do = (torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    got = attention.attention_backward(q, k, v, out, lse, do)
    err3 = err4 = lse_err = 0.0
    fwd_plain_ms = bwd_plain_ms = 0.0
    for w in windows:
        sl = lambda t: t[w : w + 1, :, heads].contiguous()
        (po, plse), ms = timed(lambda: attention.attention_plain(sl(q), sl(k), sl(v), return_lse=True))
        fwd_plain_ms += ms
        err3 = max(err3, compare("attention_forward_lse", sl(out), po, f"window {w}"))
        lse_err = max(lse_err, float((lse[w : w + 1, heads] - plse).abs().max()))
        pg, ms = timed(lambda: attention.attention_backward_plain(sl(q), sl(k), sl(v), po, plse, sl(do)))
        bwd_plain_ms += ms
        err4 = max(err4, max(compare("attention_backward", sl(g), p, f"window {w}") for g, p in zip(got, pg)))
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"attention_forward_lse {list(shape)}: lse max_abs_err {lse_err:.4g} > {LSE_ATOL}")
    del got
    n, BC, S = q.numel(), shape[0], shape[1]
    fwd_bound = bound(4 * n * 2 + BC * 48 * S * 4, 4 * BC * 48 * S * S * 64)
    bwd_bound = bound(8 * n * 2 + BC * 48 * S * 4, 10 * BC * 48 * S * S * 64)
    fwd_ms = cuda_ms(lambda: attention.attention_with_lse(q, k, v), 2)
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, out, lse, do), 2)
    log(f"  attention_forward_lse / attention_backward at the 63 s train windows {list(shape)}: max_abs_err out "
        f"{err3:.4g}, lse {lse_err:.4g}, gradients {err4:.4g} (tol {KERNEL_TOL['attention_backward']}); the plain "
        f"versions on windows {list(windows)} x heads {heads.start}-{heads.stop - 1}, forward {fwd_plain_ms:.1f} ms, "
        f"backward {bwd_plain_ms:.1f} ms; kernels over all: attention_forward_lse {fwd_ms:.3f} ms (bound "
        f"{fwd_bound[0]:.3f} ms, {fwd_bound[1]}), attention_backward {bwd_ms:.3f} ms (bound {bwd_bound[0]:.3f} ms, "
        f"{bwd_bound[1]})")
    del q, k, v, do, out, lse


def check_lse_backward(shape, gen, device) -> dict:
    """K3 with the log-sum-exp and K4 against their plain versions on unit-variance inputs of ``shape``."""
    from ttt_video_dit_torch.ops import attention

    q, k, v, do = (torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16) for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    (want_out, want_lse), fwd_plain_ms = timed(lambda: attention.attention_plain(q, k, v, return_lse=True))
    err3 = compare("attention_forward_lse", out, want_out)
    lse_err = float((lse - want_lse).abs().max())
    if not lse_err <= LSE_ATOL:
        raise AssertionError(f"attention_forward_lse {list(shape)}: lse max_abs_err {lse_err:.4g} > {LSE_ATOL}")
    got = attention.attention_backward(q, k, v, out, lse, do)
    want, bwd_plain_ms = timed(lambda: attention.attention_backward_plain(q, k, v, out, lse, do))
    err4 = max(compare("attention_backward", g, w) for g, w in zip(got, want))
    log(f"  attention_forward_lse {list(shape)}: max_abs_err out {err3:.4g}, lse {lse_err:.4g}; "
        f"attention_backward: max_abs_err {err4:.4g} (tol {KERNEL_TOL['attention_backward']})")
    return dict(args=(q, k, v, out, lse, do), err3=err3, err4=err4, fwd_plain_ms=fwd_plain_ms,
                bwd_plain_ms=bwd_plain_ms)


def phase_kernels(device) -> list[dict]:
    import torch.nn.functional as Fn

    from ttt_video_dit_torch.ops import attention, convert

    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(0)
    records = [check_ttt_forward("ttt_mlp", gen, device)]

    # K3 at the sampling slice ([2, 18048, 48, 64], one window per CFG sample) and ragged (3 windows of 417).
    sdpa = lambda q, k, v: Fn.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    for shape in ((2, SEQ, 48, 64), (3, 417, 4, 64)):
        q, k, v = (torch.randn(*shape, generator=gen, device=device).mul(2.0).to(torch.bfloat16) for _ in range(3))
        want, plain_ms = timed(lambda: attention.attention_plain(q, k, v))
        err = compare("attention_forward", attention.attention(q, k, v), want)
        log(f"  attention_forward {list(shape)}: max_abs_err {err:.4g} (tol {KERNEL_TOL['attention_forward']})")
        if shape[1] == SEQ:
            k3 = dict(qkv=(q, k, v), err=err, plain_ms=plain_ms)
    BC, S, H, F = 2, SEQ, 48, 64
    ms = cuda_ms(lambda: attention.attention(*k3["qkv"]), 5)
    lib_ms = cuda_ms(lambda: sdpa(*k3["qkv"]), 5)
    records.append(record("attention_forward", "attention_forward.cu", TPU + "ops/attention.py:265", k3["err"], ms,
                          k3["plain_ms"], 4 * BC * S * H * F * 2, 4 * BC * H * S * S * F, lib_ms))
    del k3
    records += check_ttt_training("ttt_mlp", gen, device)

    # K3 with the log-sum-exp at the training slice ([1, 18048, 48, 64]) and K4 there and ragged,
    # unit-variance inputs: the model's q and k come out of a LayerNorm.
    for shape in ((1, SEQ, 48, 64), (3, 417, 4, 64)):
        r = check_lse_backward(shape, gen, device)
        if shape[1] == SEQ:
            k4 = r
    q, k, v, out, lse, do = k4["args"]
    BC = 1
    ms = cuda_ms(lambda: attention.attention_with_lse(q, k, v), 5)
    lib_ms = cuda_ms(lambda: sdpa(q, k, v), 5)
    records.append(record("attention_forward_lse", "attention_forward.cu", TPU + "ops/attention.py:265", k4["err3"],
                          ms, k4["fwd_plain_ms"], 4 * BC * S * H * F * 2 + BC * H * S * 4, 4 * BC * H * S * S * F,
                          lib_ms))
    ms = cuda_ms(lambda: attention.attention_backward(q, k, v, out, lse, do), 3)
    ql, kl, vl = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    lib_out = Fn.scaled_dot_product_attention(ql, kl, vl)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do.transpose(1, 2), retain_graph=True), 3)
    # The function needs 5 S x S x F products per window and head (Q K^T, dO V^T, P^T dO, dS^T Q, dS K).
    records.append(record("attention_backward", "attention_backward.cu", TPU + "ops/attention.py:326", k4["err4"],
                          ms, k4["bwd_plain_ms"], 5 * BC * S * H * F * 2 + BC * H * S * 4 + 3 * BC * S * H * F * 2,
                          5 * 2 * BC * H * S * S * F, lib_ms))
    del k4, q, k, v, out, lse, do, ql, kl, vl, lib_out
    torch.cuda.empty_cache()

    records.append(check_ttt_forward("ttt_linear", gen, device))
    records += check_ttt_training("ttt_linear", gen, device)
    torch.cuda.empty_cache()

    # K7 on a [12288, 3072] float32 weight (the MLP's layer2, [out, in]) and on a ragged size; the
    # first elements are ties, subnormals, signed zeros, +-inf, NaN and values past the bf16 maximum.
    special = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 3.4e38, -3.39e38, 1e-40, -1e-45, 1.00390625,
                            1.01171875, -1.00390625, 3.0e-39], device=device)
    for shape in ((12288, 3072), (7, 5)):
        w = torch.randn(*shape, generator=gen, device=device) * 0.02
        w.view(-1)[: min(special.numel(), w.numel())] = special[: w.numel()]
        got = convert.convert_f32_bf16(w)
        want, plain_ms = timed(lambda: convert.convert_f32_bf16_plain(w))
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            bad = int((got.view(torch.int16) != want.view(torch.int16)).sum())
            raise AssertionError(f"convert_f32_bf16 {list(shape)}: {bad} elements differ from .to(torch.bfloat16)")
        log(f"  convert_f32_bf16 {list(shape)}: bit-identical to .to(torch.bfloat16)")
        if shape[0] == 12288:
            k7 = dict(w=w, plain_ms=plain_ms)
    w = k7["w"]
    ms = cuda_ms(lambda: convert.convert_f32_bf16(w), 50)
    lib_ms = cuda_ms(lambda: w.to(torch.bfloat16), 50)
    # Bound: 4 bytes read and 2 written an element, one conversion an element (bytes bound it);
    # max_abs_err 0: the check above is bit-for-bit.
    records.append(record("convert_f32_bf16", "convert.cu", TPU + "ops/pallas/convert.py:45", 0.0, ms, k7["plain_ms"],
                          6 * w.numel(), w.numel(), lib_ms))
    del k7, w
    torch.cuda.empty_cache()
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")
    return records


def phase_dit(device, variant, length: str = "3s") -> None:
    """One full-width 2-layer DiT forward at the geometry of the variant's eval TOML of ``length``, kernel
    path against the plain path (phase 3; at 9 s, phase 11)."""
    from ttt_video_dit_torch.sample import build_model, model_config, parse_args

    t0 = time.perf_counter()
    args = sample_args(variant) if length == "3s" else long_sample_args(variant, length)
    job = parse_args(args + ["--model.num_layers", "2"])
    cfg, ev = model_config(job), job.eval
    model = build_model(cfg, device, seed=1)
    gen = torch.Generator(device).manual_seed(2)
    video = torch.randn(2, ev.sampling_num_frames, 16, ev.image_height // 8, ev.image_width // 8, generator=gen,
                        device=device)
    text = torch.randn(2, cfg.num_chunks, ev.txt_maxlen, cfg.text_dim, generator=gen, device=device)
    timesteps = torch.tensor([999.0, 500.0], device=device)
    outs = {}
    with torch.inference_mode():
        for use_kernel in (False, True):
            cfg.use_kernel = use_kernel
            outs[use_kernel] = model.dit(video.to(torch.bfloat16), text, timesteps).float()
    ref, got = outs[False], outs[True]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{variant} DiT kernel-path output has non-finite values")
    rel = float((got - ref).norm() / ref.norm())
    if rel > DIT_REL_L2_TOL:
        raise AssertionError(f"{variant} DiT kernel path vs plain path: relative L2 error {rel:.4g} > {DIT_REL_L2_TOL}")
    log(f"phase {3 if length == '3s' else 11} {variant} {length} DiT d{cfg.model_dim} x {cfg.num_heads} heads x "
        f"{cfg.num_layers} layers, video {list(video.shape[1:])}, text {list(text.shape[1:3])}, kernel vs plain: "
        f"rel L2 {rel:.4g} (tol {DIT_REL_L2_TOL}), max_abs_err {float((got - ref).abs().max()):.4g}: "
        f"{time.perf_counter() - t0:.1f} s")
    del model


def reset_counts() -> None:
    from ttt_video_dit_torch.ops import attention, convert, ttt_linear_kernel, ttt_mlp_kernel

    ttt_mlp_kernel.launches = ttt_mlp_kernel.train_launches = ttt_mlp_kernel.bwd_launches = 0
    ttt_linear_kernel.launches = ttt_linear_kernel.train_launches = ttt_linear_kernel.bwd_launches = 0
    attention.launches = attention.lse_launches = attention.bwd_launches = 0
    convert.launches = 0


def read_counts() -> dict[str, int]:
    from ttt_video_dit_torch.ops import attention, convert, ttt_linear_kernel, ttt_mlp_kernel

    return {"ttt_mlp_forward": ttt_mlp_kernel.launches, "ttt_mlp_forward_train": ttt_mlp_kernel.train_launches,
            "ttt_mlp_backward": ttt_mlp_kernel.bwd_launches, "ttt_linear_forward": ttt_linear_kernel.launches,
            "ttt_linear_forward_train": ttt_linear_kernel.train_launches,
            "ttt_linear_backward": ttt_linear_kernel.bwd_launches, "attention_forward": attention.launches,
            "attention_forward_lse": attention.lse_launches, "attention_backward": attention.bwd_launches,
            "convert_f32_bf16": convert.launches}


def phase_sample(device, variant, keep: dict | None = None) -> dict[str, int]:
    """The sampling entry at 42 layers (phase 4); ``keep`` receives its latents, s/eval and peak (for phase 13)."""
    import numpy as np

    from ttt_video_dit_torch import sample

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    job = sample.parse_args(sample_args(variant))
    reset_counts()
    summary = sample.main(job)
    counts = read_counts()
    cfg = summary["model_config"]
    evals = len(summary["eval_seconds"])
    if summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"sampling ran on {summary['device']}, not the card")
    # Per eval and layer: the TTT scan once per direction, attention once.
    expect = {f"{variant}_forward": 2 * cfg.num_layers * evals, "attention_forward": cfg.num_layers * evals}
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"kernel launches {counts} do not match {cfg.num_layers} layers x {evals} evals")
    latents = np.load(summary["latents"][0])
    if latents.shape != (13, 16, 60, 90) or not np.isfinite(latents).all():
        raise AssertionError(f"latents {latents.shape} not finite of shape (13, 16, 60, 90)")
    steady = summary["eval_seconds"][1:] or summary["eval_seconds"]
    log(f"phase 4 {variant} sample d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, {evals} evals: "
        f"{sum(steady) / len(steady):.3f} s/eval after the first ({summary['eval_seconds'][0]:.3f} s first), "
        f"peak {summary['peak_memory_bytes']['dit'] / 2**30:.2f} GiB, launches "
        f"{ {k: v for k, v in counts.items() if v} }, latents finite, std {float(latents.std()):.4f}: "
        f"{time.perf_counter() - t0:.1f} s")
    if keep is not None:
        keep.update(latents=latents, eval_seconds=sum(steady) / len(steady), peak=summary["peak_memory_bytes"]["dit"])
    return counts


def phase_grad(device, variant) -> None:
    """Loss + backward of a full-width 2-layer DiT (3 s train config), kernel
    path against the plain path, same weights, batch and draws."""
    from ttt_video_dit_torch import train

    t0 = time.perf_counter()
    job = train.parse_args(train_args(variant))
    cfg = train.model_config(job)
    cfg.num_layers = 2
    model = train.build_model(cfg, device, seed=3)
    gen = torch.Generator(device).manual_seed(4)
    vid = torch.randn(1, 13, 16, 60, 90, generator=gen, device=device)
    text = torch.randn(1, 1, train.synthetic_text_length(cfg), cfg.text_dim, generator=gen, device=device)
    bounds = (torch.tensor([0], device=device), torch.tensor([1000], device=device))
    idx, noise = torch.tensor([600], device=device), torch.randn(vid.shape, generator=gen, device=device)
    policy = cfg.remat_policy  # the TOML's: save_seq
    results = {}
    for use_kernel, remat_policy in ((True, policy), (False, policy), (True, "none")):
        cfg.use_kernel, cfg.remat_policy = use_kernel, remat_policy
        model.zero_grad(set_to_none=True)
        loss = model(vid, text, bounds, idx=idx, noise=noise).mean()
        loss.backward()
        grads = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        results[use_kernel, remat_policy] = (loss.item(), grads)
        torch.cuda.synchronize()
    cfg.remat_policy = policy

    def held(what, got, want):
        (loss_k, grads_k), (loss_p, grads_p) = got, want
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        rels = {}
        for n, gp in grads_p.items():
            gk = grads_k[n]
            if not torch.isfinite(gk).all():
                raise AssertionError(f"gradient of {n} has non-finite values ({what})")
            rels[n] = float((gk - gp).norm() / gp.norm().clamp_min(1e-30))
        worst = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
        log(f"  {what}: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3g}, tol {GRAD_REL_L2_TOL['loss']}); "
            f"gradient rel L2 over {len(rels)} parameters: median {sorted(rels.values())[len(rels) // 2]:.3g}, worst "
            + ", ".join(f"{n} {r:.3g}" for n, r in worst) + f" (tol {GRAD_REL_L2_TOL['grad']})")
        if loss_rel > GRAD_REL_L2_TOL["loss"] or worst[0][1] > GRAD_REL_L2_TOL["grad"]:
            raise AssertionError(f"training gradients, {what}: loss rel {loss_rel:.4g}, worst {worst[0]}")

    held(f"kernel vs plain path under {policy}", results[True, policy], results[False, policy])
    held(f"kernel path, {policy} vs none", results[True, policy], results[True, "none"])
    log(f"phase 5 {variant} training gradients d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers: "
        f"{time.perf_counter() - t0:.1f} s")
    del model, results
    torch.cuda.empty_cache()


def check_trained(model, fresh, optimizer, steps: int) -> tuple[int, list[str]]:
    """Every trainable tensor of ``model`` must have moved from its initial
    value in ``fresh`` more than DECAY_MARGIN times as far as weight decay
    alone would have moved it over ``steps`` steps (for a tensor without
    weight decay: at all). Only a tensor whose last gradient is all zero may
    stay (it is named), and never one of the TTT state and norm that K2 or K6
    trains. Returns the count of tensors that moved and the names of those
    excused."""
    from ttt_video_dit_torch.training.optimizer import flax_path

    lr_sum = {g: sum(optimizer.learning_rates(t)[g] for t in range(steps)) for g in optimizer.schedules}
    init = dict(fresh.named_parameters())
    trained, idle, stuck = 0, [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        label = optimizer.labels[flax_path(name)]
        p0 = init[name].detach().float()
        moved = float((p.detach().float() - p0).norm())
        decay_only = lr_sum[label] * optimizer.weight_decay[label] * float(p0.norm())
        if p.grad is None or not bool(p.grad.any()):
            if name.endswith(TTT_STATE_PARAMETERS):
                stuck.append(f"{name}: zero gradient")
            idle.append(name)
        elif moved > DECAY_MARGIN * decay_only:
            trained += 1
        else:
            stuck.append(f"{name}: moved {moved:.3g}, weight decay alone {decay_only:.3g}")
    if stuck:
        raise AssertionError(f"parameters not trained ({len(stuck)}): {stuck[:8]}")
    return trained, idle


def phase_train(device, variant, remat_policy=None, length: str = "3s", keep: dict | None = None, layers: int = 4,
                steps: int = 3, phase: int | None = None) -> dict[str, int]:
    """The training entry, ``layers`` layers x ``steps`` steps at full width,
    on the card, on the variant's train TOML of ``length`` (train_toml),
    under its remat policy or ``remat_policy``; ``keep`` receives its
    losses, s/step, peak and launch counts (for phase 13)."""
    from ttt_video_dit_torch import train

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flags = ["--checkpoint.interval", "0", "--job.dump_folder", TRAIN_DIR]  # phase 9 covers saving
    job = train.parse_args(train_args(variant, length, layers, steps) + flags
                           + (["--remat.policy", remat_policy] if remat_policy else []))
    reset_counts()
    summary = train.main(job)
    counts = read_counts()
    cfg = summary["model_config"]
    if summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"training ran on {summary['device']}, not the card")
    if len(summary["losses"]) != steps or not all(map(math.isfinite, summary["losses"] + summary["grad_norms"])):
        raise AssertionError(f"losses {summary['losses']} / grad norms {summary['grad_norms']} not {steps} finite "
                             f"steps")
    # Per step and layer: the training TTT forward once per direction, and under remat policy "none" once
    # more in the per-layer recompute (save_seq keeps its outputs); its backward once per direction; K3
    # with the log-sum-exp once (twice under "none"), K4 once; with scan_layers, K7 once per 2-D layer
    # weight and forward, twice over (the recompute casts again): adaLN x 2, attention q/k/v/o, MLP x 2
    # and the TTT wq/wk/wv/wo, shared by both directions = 12.
    L = cfg.num_layers
    runs = 1 if cfg.remat_policy == "save_seq" else 2
    expect = {f"{variant}_forward_train": 2 * runs * L * steps, f"{variant}_backward": 2 * L * steps,
              "attention_forward_lse": runs * L * steps, "attention_backward": L * steps}
    if cfg.scan_layers:
        expect["convert_f32_bf16"] = 2 * 12 * L * steps
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"kernel launches {counts} do not match {L} layers x {steps} steps: {expect}")
    fresh = train.build_model(cfg, torch.device(device), job.job.seed)
    trained, idle = check_trained(summary["model"], fresh, summary["optimizer"], steps)
    frozen = sum(1 for p in summary["model"].parameters() if not p.requires_grad)
    steady = summary["step_seconds"][1:]
    mfu = [m for m in summary["mfu"][1:]]
    phase = phase or (6 if length == "3s" else 11)
    log(f"phase {phase} {variant} {length} train ({job.job.config_file}) d{cfg.model_dim} x {cfg.num_heads} heads x "
        f"{L} layers, L {cfg.num_chunks * summary['text_length'] + cfg.compressed_num_frames * cfg.tokens_per_frame}, "
        f"CS {cfg.mini_batch_size}, "
        f"K {cfg.scan_checkpoint_group_size}, adapter {cfg.adapter_method}, remat policy {cfg.remat_policy}, "
        f"{steps} steps: "
        f"{sum(steady) / len(steady):.3f} s/step after the first ({summary['step_seconds'][0]:.3f} s first), MFU "
        f"{100 * sum(mfu) / len(mfu):.2f} % after the first, peak {summary['peak_memory_bytes'] / 2**30:.2f} GiB, "
        f"losses {[round(x, 5) for x in summary['losses']]}, grad norms {[round(x, 5) for x in summary['grad_norms']]}, "
        f"{trained} trainable parameter tensors moved more than {DECAY_MARGIN:g}x weight decay alone ({frozen} "
        f"frozen), zero last gradient (not required to move): {idle or 'none'}, launches "
        f"{ {k: v for k, v in counts.items() if v} } ({CARD}): {time.perf_counter() - t0:.1f} s")
    if keep is not None:
        keep.update(losses=summary["losses"], grad_norms=summary["grad_norms"], step_seconds=sum(steady) / len(steady),
                    peak=summary["peak_memory_bytes"], counts=counts)
    del summary, fresh
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return counts


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int32 fields: negative values are 10-byte two's complement
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _pb(num: int, value) -> bytes:
    """One protobuf field: an int as a varint, a float as fixed32, bytes or str length-delimited."""
    if isinstance(value, float):
        return _varint(num << 3 | 5) + struct.pack("<f", value)
    if isinstance(value, int):
        return _varint(num << 3) + _varint(value)
    value = value.encode("utf-8") if isinstance(value, str) else value
    return _varint(num << 3 | 2) + _varint(len(value)) + value


STORY_WORDS = ("a the fluffy orange cat walks through sunlit kitchen looking for food and then jumps onto wooden table "
               "while rain falls outside window camera slowly pans across room toward dog sleeping near warm fireplace "
               "light flickers soft shadows move wall bright morning sky over quiet city street people hurry past shop "
               "with red door old man smiles waves child runs chasing blue ball green park trees sway wind").split()


def fabricated_spiece(path: str, size: int = 32000, seed: int = 0) -> list:
    """A SentencePiece unigram ``spiece.model`` of ``size`` pieces, written in
    protobuf's wire format (no protobuf here): <pad>, </s>, <unk> (T5's ids
    0, 1, 2), every printable ASCII character with and without the ``▁``
    prefix, the storyboard words, then random letter strings, scores drawn
    from ``seed``; the trainer's unk/eos/pad ids and an nmt_nfkc normalizer
    with T5's flags. Returns the pieces [(piece, score, type)]."""
    import random

    rng = random.Random(seed)
    f32 = lambda x: struct.unpack("<f", struct.pack("<f", x))[0]
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    seen = {p for p, _, _ in pieces}

    def add(p):
        if p not in seen and len(pieces) < size:
            seen.add(p)
            pieces.append((p, f32(-rng.uniform(1.0, 14.0)), 1))

    for c in ["▁"] + [chr(i) for i in range(33, 127)]:
        add(c)
        add("▁" + c)
    for w in STORY_WORDS:
        add("▁" + w)
        add(w)
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(pieces) < size:
        w = "".join(rng.choice(letters) for _ in range(rng.randint(2, 8)))
        add(w if rng.random() < 0.4 else "▁" + w)
    trainer = _pb(3, 1) + _pb(40, 2) + _pb(41, -1) + _pb(42, 1) + _pb(43, 0)
    normalizer = _pb(1, "nmt_nfkc") + _pb(3, 1) + _pb(4, 1) + _pb(5, 1)
    body = b"".join(_pb(1, _pb(1, p) + _pb(2, sc) + _pb(3, t)) for p, sc, t in pieces)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(body + _pb(2, trainer) + _pb(3, normalizer))
    return pieces


def fabricated_storyboard(path: str, scenes: int, seed: int) -> list:
    """A ``scenes``-scene storyboard JSON (one video) of seeded sentences of
    STORY_WORDS, 150-260 words a scene, with a negative prompt. Returns the
    scene texts as the sampler's loader gives them (scene tokens inserted)."""
    import random

    from ttt_video_dit_torch.models.dit.sampler import load_storyboards

    rng = random.Random(seed)
    video = [{"text": " ".join(rng.choice(STORY_WORDS) for _ in range(rng.randint(150, 260))).capitalize() + ".",
              "neg_text": "blurry, low quality, distorted"} for _ in range(scenes)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump([video], f)
    return load_storyboards(path)[0][0]


def _fabricated_t5_dir(path: str, layers: int, seed: int):
    """A T5 model directory at T5_XXL's widths cut to ``layers``: config.json
    and model.safetensors (the port's writer), seeded bf16 weights."""
    from dataclasses import asdict

    from ttt_video_dit_torch.models.t5 import T5Config, T5Encoder
    from ttt_video_dit_torch.utils import safetensors

    cfg = T5Config(**{**T5_XXL, "num_layers": layers})
    with torch.device("meta"):
        enc = T5Encoder(cfg)
    enc.to(torch.bfloat16).to_empty(device="cpu").init_weights_(torch.Generator().manual_seed(seed))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w", encoding="utf-8") as f:
        json.dump(asdict(cfg), f)
    safetensors.save_file(enc.state_dict(), os.path.join(path, "model.safetensors"))


def phase_t5(device) -> None:
    """The T5-XXL encoder at full depth on the card (seeded bf16 weights), then
    the loader end to end at 2 layers, card bf16 against CPU float32."""
    from ttt_video_dit_torch.models.t5 import T5Config, T5Encoder, load_text_encoder

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    with torch.device("meta"):
        enc = T5Encoder(T5Config(**T5_XXL))
    enc.to(torch.bfloat16).to_empty(device=device).init_weights_(torch.Generator(device).manual_seed(7))
    enc.resize_token_embeddings(T5_SCENE_VOCAB, torch.Generator(device).manual_seed(8))
    enc.eval()
    params = sum(p.numel() for p in enc.parameters())
    ids = torch.randint(0, T5_SCENE_VOCAB, (3, 2, 498), generator=torch.Generator(device).manual_seed(9), device=device)
    with torch.inference_mode():
        enc(ids[0])  # warm-up
        outs, ms = [], []
        for i in (1, 2):  # positive, then negative prompts
            out, t = timed(lambda: enc(ids[i]))
            outs.append(out)
            ms.append(t)
    want = (2, 498, T5_XXL["d_model"])
    for out in outs:
        if out.shape != want or out.dtype != torch.float32 or not torch.isfinite(out).all():
            raise AssertionError(f"T5-XXL output {tuple(out.shape)} {out.dtype} not finite float32 {want}")
    peak = torch.cuda.max_memory_allocated(device)
    c = T5_XXL
    log(f"phase 7 T5-XXL d{c['d_model']} x {c['num_heads']} heads x {c['num_layers']} layers, d_ff {c['d_ff']} "
        f"({params / 1e9:.3f} B parameters, bf16, vocab "
        f"{T5_SCENE_VOCAB}) on [2, 498] ids: {ms[0]:.2f} / {ms[1]:.2f} ms per encode (positive / negative, after a "
        f"warm-up), peak {peak / 2**30:.2f} GiB, outputs finite ({CARD})")

    # A 21-scene storyboard from text: the port's tokenizer on a fabricated 32,000-piece spiece.model (the
    # card's machine has no transformers or protobuf), then the XXL encoder on the ids.
    from ttt_video_dit_torch.models import tokenizer

    xxl_dir = os.path.join(SERVE_DIR, "t5xxl")  # the tokenizer and config.json of the entries' T5 (phases 11-12)
    pieces = fabricated_spiece(os.path.join(xxl_dir, "spiece.model"), seed=16)
    with open(os.path.join(xxl_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**T5_XXL, "model_type": "t5"}, f)
    texts = fabricated_storyboard(os.path.join(SERVE_DIR, "storyboard_63s.json"), scenes=21, seed=17)
    tok = tokenizer.load(xxl_dir)
    tok.add_special_tokens(["<end_scene>", "<start_scene>"])
    t = time.perf_counter()
    ids = tok(texts, 458)
    tok_ms = (time.perf_counter() - t) * 1e3
    lengths = [int((row != 0).sum()) for row in ids]
    if len(tok) != len(pieces) + 102 or not (ids[:, 0] != 0).all() or (ids == 2).any():
        raise AssertionError(f"tokenizer: {len(tok)} ids (expected {len(pieces) + 102}), lengths {lengths}, "
                             f"{int((ids == 2).sum())} <unk>")
    ids = torch.from_numpy(ids).to(device)
    with torch.inference_mode():
        enc(ids)  # warm-up at this shape
        emb, enc_ms = timed(lambda: enc(ids))
    if emb.shape != (21, 458, c["d_model"]) or not torch.isfinite(emb).all():
        raise AssertionError(f"T5-XXL on the storyboard: {tuple(emb.shape)} not finite [21, 458, {c['d_model']}]")
    del enc, outs, emb
    torch.cuda.empty_cache()
    log(f"  21-scene storyboard: tokenised in {tok_ms:.2f} ms ({len(tok)} ids, tokens a scene {min(lengths)}-"
        f"{max(lengths)} of 458, none unknown), T5-XXL encode of [21, 458] {enc_ms:.2f} ms ({CARD})")

    path = os.path.join(SERVE_DIR, "t5")  # 2 layers, with the tokenizer: phase 8's T5
    _fabricated_t5_dir(path, layers=2, seed=10)
    shutil.copy(os.path.join(xxl_dir, "spiece.model"), path)
    got_enc = load_text_encoder(path, "bfloat16", device)
    got = got_enc.encode(texts[:2], 458).cpu()
    want_enc = load_text_encoder(path, "float32", "cpu")
    want = want_enc.encode(texts[:2], 458)
    if not torch.equal(torch.from_numpy(got_enc.tokenizer(texts[:2], 458)), torch.from_numpy(ids[:2].cpu().numpy())):
        raise AssertionError("T5TextEncoder.encode tokenised the storyboard differently from the tokenizer alone")
    rel = float((got - want).norm() / want.norm())
    if not torch.isfinite(got).all() or not rel <= T5_REL_L2_TOL:
        raise AssertionError(f"T5 loader, 2 layers: card bf16 vs CPU float32 relative L2 {rel:.4g} > {T5_REL_L2_TOL}")
    log(f"  T5 loader end to end from text (config.json + model.safetensors + spiece.model, 2 layers, 2 scenes): card "
        f"bf16 vs CPU float32 relative L2 {rel:.4g} (tol {T5_REL_L2_TOL}), max_abs_err "
        f"{float((got - want).abs().max()):.4g}: {time.perf_counter() - t0:.1f} s")


def _fabricated_hf_shards(path: str, cfg, seed: int) -> int:
    """HF-named CogVideoX transformer tensors for ``cfg`` (bf16, seeded:
    weights N(0, 1/fan_in), biases N(0, 0.01^2), LayerNorm scales 1 + N(0,
    0.05^2)) in two shards and an index. Returns the tensor count."""
    from ttt_video_dit_torch.models.dit import from_hf
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.utils import safetensors

    with torch.device("meta"):
        shapes = {k: v.shape for k, v in CogVideoX(cfg).state_dict().items()}
    names = list(from_hf._TOP) + [f"transformer_blocks.{i}.{n}.{leaf}" for i in range(cfg.num_layers)
                                  for n in from_hf._BLOCK for leaf in ("weight", "bias")]
    g = torch.Generator().manual_seed(seed)
    tensors = {}
    for name in names:
        shape = shapes[from_hf.hf_key(name)]
        x = torch.randn(shape, generator=g)
        if name.endswith(("norm.weight", "norm_final.weight", "norm_q.weight", "norm_k.weight")):
            x = 1 + 0.05 * x
        elif name.endswith("weight"):
            x = x / math.sqrt(math.prod(shape[1:]))
        else:
            x = 0.01 * x
        tensors[name] = x.bfloat16()
    os.makedirs(path, exist_ok=True)
    half = len(names) // 2
    shards = {"diffusion_pytorch_model-00001-of-00002.safetensors": names[:half],
              "diffusion_pytorch_model-00002-of-00002.safetensors": names[half:]}
    for fn, keys in shards.items():
        safetensors.save_file({k: tensors[k] for k in keys}, os.path.join(path, fn))
    with open(os.path.join(path, "diffusion_pytorch_model.safetensors.index.json"), "w", encoding="utf-8") as f:
        json.dump({"weight_map": {k: fn for fn, keys in shards.items() for k in keys}}, f)
    return len(tensors)


def phase_serve(device) -> dict[str, int]:
    """Weights, sampling and VAE decode through the sampling entry (ttt_mlp, full width, 2 layers, 2 steps)."""
    import numpy as np

    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.models.dit import from_hf
    from ttt_video_dit_torch.models.dit.dit import cast_matmul_weights_, compute_dtype
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder
    from ttt_video_dit_torch.models.vae.enc_dec import Decoder3D

    t0 = time.perf_counter()
    flags = sample_args("ttt_mlp") + ["--model.num_layers", "2", "--eval.num_denoising_steps", "2",
                                      "--guider.num_steps", "2"]
    cfg = sample.model_config(sample.parse_args(flags))
    hf_dir, init_dir = os.path.join(SERVE_DIR, "hf"), os.path.join(SERVE_DIR, "init")
    n_hf = _fabricated_hf_shards(hf_dir, cfg, seed=12)
    conv = subprocess.run([sys.executable, "-m", "ttt_video_dit_torch.models.dit.from_hf", "--hf-dir", hf_dir,
                           "--output", init_dir, *flags], capture_output=True, text=True)
    if conv.returncode != 0:
        raise RuntimeError(f"from_hf CLI failed ({conv.returncode}): {conv.stderr[-2000:]}")
    mapped = [ln for ln in conv.stdout.splitlines() if ln.startswith("mapped ")]
    if mapped != [f"mapped {n_hf} HF tensors"]:
        raise AssertionError(f"from_hf CLI mapped {mapped}, {n_hf} HF tensors written")

    torch.manual_seed(13)  # the decoder's default initialisation, on the card
    with torch.device(device):
        dec = Decoder3D(VaeModelConfig.get_decoder_config())
    vae_path = os.path.join(SERVE_DIR, "vae.pt")
    torch.save({"state_dict": {f"decoder.{k}": v.cpu() for k, v in dec.state_dict().items()}}, vae_path)
    del dec
    torch.cuda.empty_cache()
    log(f"  serving files: {n_hf} HF tensors in 2 shards converted by the from_hf CLI, VAE 1.0 decoder checkpoint: "
        f"{time.perf_counter() - t0:.1f} s")

    t5 = ["--eval.t5_model_dir", os.path.join(SERVE_DIR, "t5")]  # phase 7's 2-layer T5 with the tokenizer
    job = sample.parse_args(flags + t5 + ["--checkpoint.init_state_dir", init_dir, "--eval.vae_checkpoint_path",
                                          vae_path, "--eval.output_dir", os.path.join(SERVE_DIR, "out")])
    reset_counts()
    summary = sample.main(job)
    counts = read_counts()
    evals = len(summary["eval_seconds"])
    expect = {"ttt_mlp_forward": 2 * cfg.num_layers * evals, "attention_forward": cfg.num_layers * evals}
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"serving run: kernel launches {counts}, expected {expect}")
    ev = job.eval
    T, H, W = ev.sampling_num_frames, ev.image_height, ev.image_width
    latents = np.load(summary["latents"][0])
    frames_path = summary["frames"][0]
    if frames_path.endswith(".npz"):
        frames = np.load(frames_path)["frames"]
        if frames.shape != (4 * T - 3, H, W, 3) or frames.dtype != np.uint8:
            raise AssertionError(f"frames {frames.shape} {frames.dtype}, expected {(4 * T - 3, H, W, 3)} uint8")
        if frames.min() == frames.max():
            raise AssertionError(f"the {list(frames.shape)} frames are constant ({frames.min()})")
    elif not os.path.getsize(frames_path):
        raise AssertionError(f"{frames_path} is empty")

    def build_in_memory(config, device, seed=0, init_state_dir=None):
        """The same HF tensors converted in this process: the entry frees it before its VAE stage."""
        model, _ = from_hf.converted_model(hf_dir, config, seed=job.job.seed)
        return cast_matmul_weights_(model.to(device), compute_dtype(config)).eval()

    in_memory_job = sample.parse_args(flags + t5 + ["--eval.output_dir", os.path.join(SERVE_DIR, "in_memory")])
    build = sample.build_model
    sample.build_model = build_in_memory
    try:
        in_memory = np.load(sample.main(in_memory_job)["latents"][0])
    finally:
        sample.build_model = build
    torch.cuda.empty_cache()
    if latents.shape != (T, 16, H // 8, W // 8) or not np.isfinite(latents).all() or not np.array_equal(latents, in_memory):
        raise AssertionError(f"latents {latents.shape} from the converted directory differ from the in-memory "
                             f"state dict's: max |diff| {float(np.abs(latents - in_memory).max()):.4g}")
    peaks = summary["peak_memory_bytes"]
    log(f"phase 8 serving ttt_mlp d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, {evals} evals: "
        f"init_state_dir latents == in-memory latents, set-up {summary['setup_seconds']:.2f} s, "
        f"{sum(summary['eval_seconds'][1:]) / max(evals - 1, 1):.3f} s/eval after the first, VAE decode of "
        f"{list(latents.shape)} latents to {os.path.basename(frames_path)} {[4 * T - 3, H, W, 3]} uint8 "
        f"{summary['vae_seconds'][0]:.2f} s, peak "
        f"GiB by stage {{{', '.join(f'{k}: {v / 2**30:.2f}' for k, v in peaks.items())}}}, launches "
        f"{ {k: v for k, v in counts.items() if v} } ({CARD}): {time.perf_counter() - t0:.1f} s")

    for what, z in (("crop [1, 16, 3, 8, 8]", torch.randn(1, 16, 3, 8, 8, generator=torch.Generator().manual_seed(14))),
                    (f"the run's first latent frame [1, 16, 1, {H // 8}, {W // 8}]",
                     torch.from_numpy(latents[None, :1]).transpose(1, 2))):
        t = time.perf_counter()
        got = VideoAutoencoder.load_decoder(vae_path, device=device).decode_first_stage(z).cpu()
        want = VideoAutoencoder.load_decoder(vae_path, device="cpu").decode_first_stage(z)
        rel, err, scale = float((got - want).norm() / want.norm()), float((got - want).abs().max()), float(want.abs().max())
        shape = (1, 3, 4 * z.shape[2] - 3, 8 * z.shape[3], 8 * z.shape[4])
        if got.shape != shape or not torch.isfinite(got).all() or not rel <= VAE_REL_L2_TOL \
                or err > VAE_MAX_TOL * scale:
            raise AssertionError(f"VAE {what} -> {tuple(got.shape)} (expected {shape}), card vs CPU: relative L2 "
                                 f"{rel:.4g} (tol {VAE_REL_L2_TOL}), max_abs_err {err:.4g} (tol {VAE_MAX_TOL} x {scale:.4g})")
        log(f"  VAE {what} -> {list(got.shape)}, card vs CPU float32: relative L2 {rel:.4g} "
            f"(tol {VAE_REL_L2_TOL}), max_abs_err {err:.4g} (tol {VAE_MAX_TOL} x max {scale:.4g}): "
            f"{time.perf_counter() - t:.1f} s")
    return counts


def _fabricated_dataset(path: str, samples: int, seed: int) -> str:
    """``samples`` precomputed 3 s samples from a seed: a latent posterior
    (mean and logvar) [13, 32, 60, 90] and one scene's text embedding
    [498, 4096], float32, alternately ``.npy`` and ``torch.save``d ``.pt``
    (a sample's two files in different formats), and ``meta.jsonl`` naming
    them relative to ``path``. Returns the JSONL file."""
    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    lines = []
    for i in range(samples):
        mean = rng.standard_normal((13, 16, 60, 90), dtype=np.float32)
        logvar = (rng.standard_normal((13, 16, 60, 90), dtype=np.float32) * 0.5 - 4.0).astype(np.float32)
        text = rng.standard_normal((498, 4096), dtype=np.float32)
        vid_name, text_name = (f"vid_{i}.npy", f"text_{i}.pt") if i % 2 == 0 else (f"vid_{i}.pt", f"text_{i}.npy")
        for name, arr in ((vid_name, np.concatenate([mean, logvar], axis=1)), (text_name, text)):
            if name.endswith(".npy"):
                np.save(os.path.join(path, name), arr)
            else:
                torch.save(torch.from_numpy(arr), os.path.join(path, name))
        lines.append(json.dumps({"vid_emb": vid_name, "text_chunk_emb": [text_name]}))
    meta = os.path.join(path, "meta.jsonl")
    with open(meta, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return meta


def data_train_flags(meta: str, interval: int, dump: str) -> list[str]:
    """The training entry on phase 9's fabricated samples: ttt_mlp 3 s TOML at 2 layers, 3 steps, a checkpoint
    every ``interval`` steps under ``dump``."""
    return ["--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "2", "--training.steps", "3",
            "--training.global_batch_size", "1", "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
            "--training.dataset_path", os.path.join(DATA_DIR, "data"), "--training.jsonl_paths", meta,
            "--checkpoint.interval", str(interval), "--job.dump_folder", dump]


def recording_batches(seen: list):
    """A DataModule.batches that appends a copy of each batch it yields to ``seen``."""
    from ttt_video_dit_torch.data import dataset

    batches = dataset.DataModule.batches

    def recording(self, *args, **kwargs):
        for b in batches(self, *args, **kwargs):
            seen.append({k: v.copy() for k, v in b.items()})
            yield b

    return recording


def phase_resume(device) -> dict[str, int]:
    """The training entry on fabricated precomputed latents (ttt_mlp 3 s TOML,
    full width, 2 layers), saving and resuming: run A takes 3 steps with
    --checkpoint.interval 2 (saves at steps 2 and 3); run B resumes from step
    2 and takes step 3. B's step-3 batch and loss equal A's bit for bit (the
    restore is exact and the forward deterministic), the sampler states after
    step 3 are equal, the grad norms within RESUME_GRAD_NORM_RTOL and every
    parameter within 2 x its group's learning rate (K4 adds dq in an order
    that varies between runs, so step 3's gradients and update may differ in
    their last bits)."""
    import numpy as np

    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.data import dataset
    from ttt_video_dit_torch.training.optimizer import flax_path

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    meta = _fabricated_dataset(os.path.join(DATA_DIR, "data"), samples=4, seed=15)
    log(f"  dataset: 4 samples (posteriors [13, 32, 60, 90], text [498, 4096], .npy and .pt): "
        f"{time.perf_counter() - t0:.1f} s")
    flags = data_train_flags(meta, interval=2, dump=os.path.join(DATA_DIR, "run"))
    seen = []
    batches = dataset.DataModule.batches
    dataset.DataModule.batches = recording_batches(seen)
    try:
        reset_counts()
        a = train.main(train.parse_args(flags))
        counts = read_counts()
        batches_a, seen[:] = list(seen), []
        shutil.rmtree(os.path.join(DATA_DIR, "run", "checkpoint", "3"))  # B resumes from step 2 and saves step 3
        b = train.main(train.parse_args(flags + ["--checkpoint.resume", "--checkpoint.resume_step", "2"]))
        batches_b = list(seen)
    finally:
        dataset.DataModule.batches = batches
    L = a["model_config"].num_layers
    expect = {"ttt_mlp_forward_train": 2 * L * 3, "ttt_mlp_backward": 2 * L * 3, "attention_forward_lse": L * 3,
              "attention_backward": L * 3, "convert_f32_bf16": 2 * 12 * L * 3}
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"run A: kernel launches {counts}, expected {expect}")
    if [c["step"] for c in a["checkpoints"]] != [2, 3] or b["start_step"] != 2 or len(b["losses"]) != 1:
        raise AssertionError(f"run A saved {[c['step'] for c in a['checkpoints']]} (expected [2, 3]); run B started at "
                             f"{b['start_step']} and took {len(b['losses'])} steps (expected 2 and 1)")
    if a["text_length"] != 498 or len(batches_a) != 3 or len(batches_b) != 1:
        raise AssertionError(f"text length {a['text_length']}, batches {len(batches_a)} / {len(batches_b)}")
    same_batch = all(np.array_equal(batches_a[2][k], batches_b[0][k]) for k in ("vid", "text"))
    if not same_batch or a["losses"][2] != b["losses"][0] or a["sampler_state"] != b["sampler_state"]:
        raise AssertionError(f"resume: step-3 batch equal {same_batch}, loss {a['losses'][2]!r} vs {b['losses'][0]!r}, "
                             f"sampler {a['sampler_state']} vs {b['sampler_state']}")
    norm_rel = abs(a["grad_norms"][2] - b["grad_norms"][0]) / a["grad_norms"][2]
    if not norm_rel <= RESUME_GRAD_NORM_RTOL:
        raise AssertionError(f"resume: step-3 grad norm {a['grad_norms'][2]} vs {b['grad_norms'][0]}")
    opt = a["optimizer"]
    lrs = opt.learning_rates(2)
    got = dict(b["model"].named_parameters())
    worst, n_equal = (0.0, ""), 0
    for name, p in a["model"].named_parameters():
        diff = float((p.detach() - got[name].detach()).abs().max())
        n_equal += diff == 0.0
        lr = lrs[opt.labels[flax_path(name)]]
        if diff > 2 * lr:
            raise AssertionError(f"resume: {name} differs by {diff:.4g} > 2 x lr {lr:.3g}")
        worst = max(worst, (diff / lr, name))
    n_params = len(got)
    data_wait = a["data_seconds"][1:]
    loads = a["load_seconds"]
    saves = a["checkpoints"]
    log(f"phase 9 data, save, resume: ttt_mlp d{a['model_config'].model_dim} x {L} layers on 4 fabricated samples "
        f"(text length {a['text_length']} from the files): run A losses {a['losses']}, run B (from step 2) "
        f"{b['losses']}; step-3 batch and loss bit-equal, sampler "
        f"{ {k: v for k, v in b['sampler_state'].items() if k != 'rng'} } (and its generator) equal, grad norm "
        f"rel diff "
        f"{norm_rel:.3g} (tol {RESUME_GRAD_NORM_RTOL}), parameters: {n_equal} of {n_params} bit-equal, worst "
        f"{worst[1]} {worst[0]:.3g} x lr (tol 2); loader {sum(loads) / len(loads):.3f} s a batch (worker), wait for "
        f"the next batch {sum(data_wait) / len(data_wait):.4f} s after the first ({a['data_seconds'][0]:.3f} s first) "
        f"against {sum(a['step_seconds'][1:]) / 2:.3f} s/step: "
        f"{'hidden under the step' if max(data_wait) < 0.1 * min(a['step_seconds'][1:]) else 'NOT hidden'}; saves "
        + ", ".join(f"step {c['step']} {c['bytes'] / 2**30:.3f} GiB in {c['seconds']:.2f} s "
                    f"({c['bytes'] / c['seconds'] / 2**30:.2f} GiB/s)" for c in saves)
        + f"; restore {b['restore']['bytes'] / 2**30:.3f} GiB in {b['restore']['seconds']:.2f} s "
        f"({b['restore']['bytes'] / b['restore']['seconds'] / 2**30:.2f} GiB/s); peak A "
        f"{a['peak_memory_bytes'] / 2**30:.2f} GiB ({CARD}): {time.perf_counter() - t0:.1f} s")
    del a, b, got, opt
    torch.cuda.empty_cache()
    return counts


class Preempted(Exception):
    """Stands in for Slurm's preemption signal in phase 17: raised in place of a training step."""


def _free_job_id(base: int, span: int) -> str:
    """A SLURM_JOB_ID whose MASTER_PORT (``base`` + id mod ``span``, train_submitit's rule) is free now."""
    while True:
        port = _free_port()
        if base <= port < base + span:
            return str(port - base)


def phase_requeue(device) -> dict[str, int]:
    """Phase 17: the Slurm launcher's in-job half (train_submitit.Trainer, no
    submitit on the card's machine) in a fabricated one-task Slurm
    environment (SLURM_NTASKS 1, SLURM_PROCID 0, SLURM_LOCALID 0, this host's
    name as the node list), on phase 9's fabricated samples (ttt_mlp 3 s TOML,
    full width, 2 layers, a checkpoint every step). Run A saves steps 1 and 2,
    computes step 3 and is preempted while saving it; the Trainer that A's
    checkpoint() hands to submitit (a stand-in DelayedSubmission, as submitit
    would requeue it) resumes from step 2 and takes step 3 again. Its step-3
    batch and loss equal A's bit for bit, the sampler states are equal, the
    grad norms and parameters are held as phase 9 holds them. (A's own step 3
    is the uninterrupted reference: a second, independent run would differ
    from the first update on, as K4 adds dq in an order that varies.) Both
    runs go through torchrun's branch (NCCL, a group of one, FSDP2)."""
    import socket
    import types

    import numpy as np

    from ttt_video_dit_torch import train, train_submitit
    from ttt_video_dit_torch.data import dataset
    from ttt_video_dit_torch.training import checkpoint, train_step
    from ttt_video_dit_torch.training.optimizer import flax_path

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    host = socket.gethostname()
    try:
        socket.getaddrinfo(host, None)
    except OSError:
        log(f"  this host's name {host!r} does not resolve; the node list is localhost")
        host = "localhost"
    slurm = {"SLURM_NTASKS": "1", "SLURM_PROCID": "0", "SLURM_LOCALID": "0", "SLURM_JOB_NODELIST": host,
             "SLURM_JOB_ID": _free_job_id(train_submitit.PORT_BASE, train_submitit.PORT_SPAN)}
    dump = os.path.join(DATA_DIR, "requeue")
    submitit = types.ModuleType("submitit")  # what checkpoint() needs of it: helpers.DelayedSubmission
    submitit.helpers = types.SimpleNamespace(DelayedSubmission=lambda fn, *args, **kwargs: (fn, args, kwargs))
    summaries, seen, steps_a, at_step_3 = [], [], [], {}
    main, batches = train.main, dataset.DataModule.batches
    step, save = train_step.train_step, checkpoint.Checkpointer.save
    full = lambda p: (p.full_tensor() if hasattr(p, "full_tensor") else p).detach().clone()

    def keeping(job):  # the Trainer returns the summary without the model: keep it whole here
        summaries.append(main(job))
        return summaries[-1]

    def recording_step(*args, **kwargs):
        out = step(*args, **kwargs)
        steps_a.append((float(out["loss"]), float(out["grad_norm"])))
        return out

    def preempted_save(self, n, model, optimizer, sampler_state, *args, **kwargs):
        if n < 3:
            return save(self, n, model, optimizer, sampler_state, *args, **kwargs)
        at_step_3.update(sampler=sampler_state, optimizer=optimizer,
                         params={name: full(p) for name, p in model.named_parameters()})
        raise Preempted

    saved_env = dict(os.environ)
    os.environ.update(slurm)
    train.main, dataset.DataModule.batches, sys.modules["submitit"] = keeping, recording_batches(seen), submitit
    train_step.train_step, checkpoint.Checkpointer.save = recording_step, preempted_save
    try:
        reset_counts()
        first = train_submitit.Trainer(data_train_flags(os.path.join(DATA_DIR, "data", "meta.jsonl"), interval=1,
                                                        dump=dump))
        try:
            first()
            raise AssertionError("run A was not preempted")
        except Preempted:
            pass
        exported = {k: os.environ[k] for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        train_step.train_step, checkpoint.Checkpointer.save = step, save
        saved_a = sorted(os.listdir(os.path.join(dump, "checkpoint")))
        batches_a, seen[:] = list(seen), []
        fn, args, kwargs = first.checkpoint()
        fn(*args, **kwargs)
        counts = read_counts()
        batches_c = list(seen)
    finally:
        train.main, dataset.DataModule.batches = main, batches
        train_step.train_step, checkpoint.Checkpointer.save = step, save
        del sys.modules["submitit"]
        os.environ.clear()
        os.environ.update(saved_env)
    (c,) = summaries
    L = c["model_config"].num_layers
    expect = {"ttt_mlp_forward_train": 2 * L * 4, "ttt_mlp_backward": 2 * L * 4, "attention_forward_lse": L * 4,
              "attention_backward": L * 4, "convert_f32_bf16": 2 * 12 * L * 4}  # A's 3 steps, then step 3 again
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"kernel launches {counts}, expected {expect}")
    if fn.argv != first.argv + ["--checkpoint.resume"] or saved_a != ["1", "2"] or c["mesh"] != (1, 1, 1):
        raise AssertionError(f"requeued argv {fn.argv}, run A saved {saved_a}, mesh {c['mesh']}")
    if c["start_step"] != 2 or len(c["losses"]) != 1 or len(batches_a) != 3 or len(batches_c) != 1:
        raise AssertionError(f"the requeued run started at {c['start_step']} and took {len(c['losses'])} steps "
                             f"(expected 2 and 1); batches {len(batches_a)} / {len(batches_c)}")
    (loss_a, norm_a), same_batch = steps_a[2], all(np.array_equal(batches_a[2][k], batches_c[0][k])
                                                   for k in ("vid", "text"))
    if not same_batch or loss_a != c["losses"][0] or at_step_3["sampler"] != c["sampler_state"]:
        raise AssertionError(f"requeue: step-3 batch equal {same_batch}, loss {loss_a!r} vs {c['losses'][0]!r}, "
                             f"sampler {at_step_3['sampler']} vs {c['sampler_state']}")
    norm_rel = abs(norm_a - c["grad_norms"][0]) / norm_a
    if not norm_rel <= RESUME_GRAD_NORM_RTOL:
        raise AssertionError(f"requeue: step-3 grad norm {norm_a} vs {c['grad_norms'][0]}")
    opt = at_step_3["optimizer"]
    lrs = opt.learning_rates(2)
    worst, n_equal = (0.0, ""), 0
    for name, p in c["model"].named_parameters():
        diff = float((full(p) - at_step_3["params"][name]).abs().max())
        n_equal += diff == 0.0
        lr = lrs[opt.labels[flax_path(name)]]
        if diff > 2 * lr:
            raise AssertionError(f"requeue: {name} differs by {diff:.4g} > 2 x lr {lr:.3g}")
        worst = max(worst, (diff / lr, name))
    log(f"phase 17 Slurm requeue: train_submitit.Trainer in a fabricated one-task Slurm environment "
        f"({', '.join(f'{k}={v}' for k, v in slurm.items())}; exported {exported}), without submitit; ttt_mlp "
        f"d{c['model_config'].model_dim} x {L} layers on phase 9's samples, mesh {' x '.join(map(str, c['mesh']))} "
        f"(NCCL, FSDP2): run A losses {[l for l, _ in steps_a]}, saved steps {saved_a}, preempted while saving "
        f"step 3; the Trainer its checkpoint() returned (argv + --checkpoint.resume) resumed at step "
        f"{c['start_step']}: loss {c['losses']}, step-3 batch and loss bit-equal to A's, sampler (and its "
        f"generator) equal, grad norm rel diff {norm_rel:.3g} (tol {RESUME_GRAD_NORM_RTOL}), parameters {n_equal} "
        f"of {len(at_step_3['params'])} bit-equal, worst {worst[1]} {worst[0]:.3g} x lr (tol 2); restore "
        f"{c['restore']['bytes'] / 2**30:.3f} GiB in {c['restore']['seconds']:.2f} s, peak "
        f"{c['peak_memory_bytes'] / 2**30:.2f} GiB ({CARD}): {time.perf_counter() - t0:.1f} s")
    del c, opt, summaries, at_step_3
    _collected_gib()
    return counts


# The long-context shapes (phases 10-12). 63 s sampling: 21 scenes of 458 text tokens and 253 latent frames of
# 30 x 45 tokens, L = 351,168, NC = 21,948 mini-batches of 16, 21 attention windows of S = 458 + 13 x 1,350 =
# 18,008 tokens a CFG sample. 9 s: 3 scenes of 502 and 37 frames, L = 51,456, 3 windows of S = 18,052.
SEQ_63S, S_63S, S_9S = 351168, 18008, 18052
# 63 s training (the TTT-MLP train TOML, 21 scenes of 522 synthetic text tokens): windows of 522 + 13 x 1,350 tokens.
S_63S_TRAIN = 18072
# Mini-batches of the 63 s scan's tail held to the plain scan: 4,096 tokens, of which batch row 1's last 3,286
# lie past element 2^31 of the [2, L, 3072] tensors.
TAIL = 256
INT31 = 2**31


def _long_meta(variant):
    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata

    cfg = sample.model_config(sample.parse_args(long_sample_args(variant, "63s")))
    return cfg, sequence_metadata(cfg, num_frames=253, latent_height=60, latent_width=90, num_scenes=21,
                                  text_length=458)


def _scan_slice(a: dict, b: int, heads: slice, mbs: slice) -> dict:
    """The inputs of batch row ``b``, ``heads`` and mini-batches ``mbs`` of a TTT scan, contiguous."""
    cols = slice(heads.start * 64, heads.stop * 64)
    out = {n: a[n][b : b + 1, mbs, :, cols].contiguous() for n in ("XQ", "XK", "XV")}
    out["gate"] = a["gate"][b : b + 1, heads, mbs].contiguous()
    out.update({n: a[n][mbs].contiguous() for n in ("rope_cos", "rope_sin")})
    out.update({n: v[heads].contiguous() for n, v in a.items() if n not in out})
    return out


def check_long_scan(variant, gen, device, H: int = 48) -> None:
    """K1 or K5 on the full 63 s tensors [2, 351,168, 48 x 64] (2,157,576,192 elements), with the 63 s rope tables.
    The gate is -1e4 (eta 0: the state stays the initial one) but on the last TAIL mini-batches, so the kernel's
    output there equals the plain scan run from the initial state on the tail alone: held on batch row 1's last
    two heads, whose output offsets pass 2^31, and, at eta 0, on batch row 0's first two heads' first 64
    mini-batches."""
    mod, name = _ttt_module(variant), f"{variant}_forward"
    kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    cfg, meta = _long_meta(variant)
    CS, NC = cfg.mini_batch_size, SEQ_63S // cfg.mini_batch_size
    eta = cfg.ttt_base_lr / 64 / CS
    a = _ttt_inputs(1, H, 1, gen, device, None, CS=CS, variant=variant)  # the state and LN affine
    from ttt_video_dit_torch.models.ttt.layer import scan_rope_tables

    a["rope_cos"], a["rope_sin"] = scan_rope_tables(meta, 64, cfg.rope_theta, CS, device)
    a.update({n: torch.randn(2, NC, CS, H * 64, generator=gen, device=device, dtype=torch.bfloat16)
              for n in ("XQ", "XK", "XV")})
    a["gate"] = torch.randn(2, H, NC, CS, generator=gen, device=device)
    a["gate"][:, :, : NC - TAIL] = -1e4
    out = kernel(**a, eta_scale=eta)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: kernel(**a, eta_scale=eta), 2)
    last = out.numel() - 1
    checks = ((f"batch row 1, heads {H - 2}-{H - 1}, the tail", 1, slice(H - 2, H), slice(NC - TAIL, NC)),
              ("batch row 0, heads 0-1, mini-batches 0-63 at eta 0", 0, slice(0, 2), slice(0, 64)))
    errs = []
    for what, b, heads, mbs in checks:
        want = plain(**_scan_slice(a, b, heads, mbs), eta_scale=eta)
        got = out[b : b + 1, mbs, :, heads.start * 64 : heads.stop * 64]
        errs.append(f"{what} max_abs_err {compare(name, got, want, what):.4g}")
    first = ((NC + NC - TAIL) * CS) * H * 64 + (H - 2) * 64  # batch row 1's tail, head H - 2: its first element
    if last < INT31 or first + (TAIL * CS - 1) * H * 64 < INT31:
        raise AssertionError(f"{name}: the checked rows do not pass 2^31 ({first}, {last})")
    bound_ms, bound_by = bound(_ttt_bytes(variant, 2, H, NC, CS), 2 * H * NC * _ttt_flops_per_step(variant, CS))
    log(f"  {name} [2, {SEQ_63S}, {H} x 64] ({out.numel():,} elements, the last at offset {last:,} > 2^31), "
        f"NC {NC}, eta_scale {eta:.4g} on the last {TAIL} mini-batches: " + "; ".join(errs)
        + f" (tol {KERNEL_TOL[name]}); kernel {ms:.3f} ms a scan, bound {bound_ms:.3f} ms ({bound_by})")
    del a, out


def phase_long_kernels(device) -> None:
    """K1, K5 and K3 on tensors of more than 2^31 elements (the 63 s shapes), K3 at the ragged 63 s and 9 s window
    lengths, K3-lse and K4, K1-train and K2, K5-train and K6 at the 9 s training shapes, each against its plain
    version."""
    from ttt_video_dit_torch.ops import attention

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device).manual_seed(20)
    for variant in VARIANTS:
        check_long_scan(variant, gen, device)
        torch.cuda.empty_cache()
    # K3 at 63 s ([42, 18,008, 48, 64]: window 41 starts at element 2,268,008,448) on windows 0 and 41, and at 9 s
    # ([6, 18,052, 48, 64]) on every window; neither S is a multiple of the 128-row KV block.
    for shape, windows in (((42, S_63S, 48, 64), (0, 41)), ((6, S_9S, 48, 64), range(6))):
        q, k, v = (torch.randn(*shape, generator=gen, device=device, dtype=torch.bfloat16).mul_(2.0)
                   for _ in range(3))
        out = attention.attention(q, k, v)
        errs = [compare("attention_forward", out[w : w + 1], attention.attention_plain(q[w : w + 1], k[w : w + 1],
                                                                                      v[w : w + 1]), f"window {w}")
                for w in windows]
        ms = cuda_ms(lambda: attention.attention(q, k, v), 2)
        BC, S = shape[:2]
        bound_ms, bound_by = bound(4 * q.numel() * 2, 4 * BC * 48 * S * S * 64)
        log(f"  attention_forward {list(shape)} ({q.numel():,} elements a tensor; window {windows[-1]} starts at "
            f"{windows[-1] * shape[1] * 48 * 64:,}): windows {list(windows)} max_abs_err {max(errs):.4g} "
            f"(tol {KERNEL_TOL['attention_forward']}); kernel {ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        del q, k, v, out
    torch.cuda.empty_cache()
    r = check_lse_backward((3, S_9S, 48, 64), gen, device)
    q, k, v, out, lse, do = r["args"]
    n = q.numel()
    fwd_bound = bound(4 * n * 2 + 3 * 48 * S_9S * 4, 4 * 3 * 48 * S_9S * S_9S * 64)
    bwd_bound = bound(8 * n * 2 + 3 * 48 * S_9S * 4, 10 * 3 * 48 * S_9S * S_9S * 64)
    log(f"    kernels at [3, {S_9S}, 48, 64]: attention_forward_lse "
        f"{cuda_ms(lambda: attention.attention_with_lse(q, k, v), 2):.3f} ms (bound {fwd_bound[0]:.3f} ms, "
        f"{fwd_bound[1]}), attention_backward {cuda_ms(lambda: attention.attention_backward(q, k, v, out, lse, do), 2):.3f}"
        f" ms (bound {bwd_bound[0]:.3f} ms, {bwd_bound[1]})")
    del r, q, k, v, out, lse, do
    torch.cuda.empty_cache()
    for variant in VARIANTS:
        check_long_training(variant, gen, device)
        torch.cuda.empty_cache()
        check_63s_training(variant, gen, device)
        torch.cuda.empty_cache()
    check_63s_attention(gen, device)
    torch.cuda.empty_cache()
    log(f"phase 10 long-context kernels vs plain ({CARD}): {time.perf_counter() - t0:.1f} s")


class _Tee:
    """A stdout that also keeps what is written to it."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_long_sample(device, variant: str, length: str, input_file: str, vae_path: str | None = None) -> dict:
    """The sampling entry on the variant's eval TOML of ``length`` at its 42 layers, 2 denoise steps, random DiT
    weights, from the storyboard's text: the tokenizer of phase 7's directory and the T5-XXL encoder with phase 7's
    seeded weights (its loader draws them in place of reading a 9.5 GB file); with ``vae_path``, the VAE decode.
    Launch counts from exactly that run; finite latents of the TOML's shape; the [parallelism] warning exactly
    when the TOML asks for more than one card; s/eval and each stage's peak."""
    import numpy as np

    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.models import t5

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    flags = long_sample_args(variant, length) + [
        "--eval.input_file", input_file, "--eval.t5_model_dir", os.path.join(SERVE_DIR, "t5xxl"),
        "--eval.output_dir", os.path.join(SERVE_DIR, f"out_{variant}_{length}")]
    job = sample.parse_args(flags + (["--eval.vae_checkpoint_path", vae_path] if vae_path else []))
    load = t5.T5Encoder.load_hf_weights
    t5.T5Encoder.load_hf_weights = lambda enc, _dir: enc.init_weights_(
        torch.Generator(enc.shared.weight.device).manual_seed(7))
    stdout, sys.stdout = sys.stdout, _Tee(sys.stdout)
    try:
        reset_counts()
        summary = sample.main(job)
        counts = read_counts()
    finally:
        printed, sys.stdout = "".join(sys.stdout.text), stdout
        t5.T5Encoder.load_hf_weights = load
    cfg, ev, evals = summary["model_config"], job.eval, len(summary["eval_seconds"])
    expect = {f"{variant}_forward": 2 * cfg.num_layers * evals, "attention_forward": cfg.num_layers * evals}
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"{length} sampling: kernel launches {counts}, expected {expect}")
    par = job.parallelism
    wants_more = max(par.dp_replicate, par.dp_sharding, par.tp_sharding) > 1
    if wants_more != ("WARNING: [parallelism] asks for" in printed):
        raise AssertionError(f"{length} sampling: [parallelism] {par.dp_replicate}/{par.dp_sharding}/"
                             f"{par.tp_sharding}, warning printed: {not wants_more}")
    T = ev.sampling_num_frames
    latents = np.load(summary["latents"][0])
    if latents.shape != (T, 16, ev.image_height // 8, ev.image_width // 8) or not np.isfinite(latents).all():
        raise AssertionError(f"{length} latents {latents.shape} not finite of shape {(T, 16, 60, 90)}")
    decoded = ""
    if vae_path:
        frames = np.load(summary["frames"][0])["frames"]
        want = (4 * T - 3, ev.image_height, ev.image_width, 3)
        if frames.shape != want or frames.dtype != np.uint8 or frames.min() == frames.max():
            raise AssertionError(f"frames {frames.shape} {frames.dtype} (min {frames.min()}, max {frames.max()}): "
                                 f"expected non-constant {want} uint8")
        decoded = f", VAE decode to {list(want)} uint8 {summary['vae_seconds'][0]:.2f} s"
    steady = summary["eval_seconds"][1:] or summary["eval_seconds"]
    peaks = summary["peak_memory_bytes"]
    log(f"phase {12 if length == '63s' else 11} {variant} {length} sample from {summary['windows']} scenes of text: "
        f"L {summary['seq_len']}, {summary['windows']} windows, d{cfg.model_dim} x {cfg.num_heads} heads "
        f"x {cfg.num_layers} layers, {evals} evals: {sum(steady) / len(steady):.3f} s/eval after the first "
        f"({summary['eval_seconds'][0]:.3f} s first), T5 stage {summary['t5_seconds']:.2f} s{decoded}, peak GiB by "
        f"stage {{{', '.join(f'{k}: {v / 2**30:.2f}' for k, v in peaks.items())}}}, launches "
        f"{ {k: v for k, v in counts.items() if v} }, [parallelism] warning {'printed' if wants_more else 'not asked for'}"
        f", latents {list(latents.shape)} finite, std {float(latents.std()):.4f} ({CARD}): "
        f"{time.perf_counter() - t0:.1f} s")
    del summary
    torch.cuda.empty_cache()
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _as_torchrun_rank_0(run):
    """``run()`` with the environment torchrun gives rank 0 of a world of one (a fresh port each time)."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port())}
    os.environ.update(env)
    try:
        return run()
    finally:
        for key in env:
            del os.environ[key]


def _collected_gib() -> float:
    """Collect garbage (an FSDP2 model's hooks hold reference cycles), free the
    cached blocks, and return the GiB still allocated on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def phase_distributed(device, trained: dict, sampled: dict) -> dict[str, int]:
    """Phase 13: the entries' torchrun branch at world size 1 (NCCL, the mesh,
    the tensor plan, FSDP2 in training) against phase 6's training run
    (``trained``) and phase 4's sampling run (``sampled``) of ttt_mlp. Each
    run starts after a garbage collection, and its line prints what was
    still allocated then (phases 4 and 6 ran first in a fresh process)."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor

    from ttt_video_dit_torch import sample, train

    t0 = time.perf_counter()
    held = _collected_gib()
    job = train.parse_args(train_args("ttt_mlp") + ["--parallelism.tp_sharding", "1", "--checkpoint.interval", "0",
                                                    "--job.dump_folder", TRAIN_DIR])
    reset_counts()
    summary = _as_torchrun_rank_0(lambda: train.main(job))
    counts = read_counts()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    model, cfg = summary["model"], summary["model_config"]
    layer, attention = model.dit.layers[0], model.dit.layers[0].seq_modeling_block.attention
    if dist.is_initialized() or summary["mesh"] != (1, 1, 1) or summary["device"] != "cuda:0":
        raise AssertionError(f"training: mesh {summary['mesh']} on {summary['device']}, process group left "
                             f"{not dist.is_initialized()}; expected 1 x 1 x 1 on cuda:0, left")
    if not (isinstance(layer, FSDPModule) and isinstance(model, FSDPModule)
            and isinstance(attention.q.weight, DTensor) and attention.tp.size == 1 and attention.q.style == "colwise"
            and model.dit.tp is attention.tp and layer.seq_modeling_block.tp is attention.tp):
        raise AssertionError("training: FSDP2 or the tensor plan was not applied")
    if counts != trained["counts"]:
        raise AssertionError(f"training launches {counts} != phase 6's {trained['counts']}")
    want, got = trained["losses"], summary["losses"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or not loss_rel <= DIST_LOSS_RTOL:
        raise AssertionError(f"training losses {got} against phase 6's {want}: rel {loss_rel:.3g} > {DIST_LOSS_RTOL}")
    steady = summary["step_seconds"][1:]
    step_s = sum(steady) / len(steady)
    log(f"phase 13 ttt_mlp 3s train through torchrun's branch, world 1 (NCCL, mesh 1 x 1 x 1, FSDP2 per layer, "
        f"heads and the sequence-parallel stream over a tensor group of one) d{cfg.model_dim} x {cfg.num_layers} layers, remat {cfg.remat_policy}: losses {got} vs "
        f"phase 6's {want} (largest rel difference {loss_rel:.3g}, tol {DIST_LOSS_RTOL}; step 1 bit-equal "
        f"{got[0] == want[0]}), grad norms {summary['grad_norms']} vs {trained['grad_norms']}, {step_s:.3f} s/step after the first vs phase 6's {trained['step_seconds']:.3f} "
        f"({100 * (step_s / trained['step_seconds'] - 1):+.2f} %), peak {summary['peak_memory_bytes'] / 2**30:.2f} GiB "
        f"vs {trained['peak'] / 2**30:.2f} GiB ({held:.2f} GiB allocated before the run), launches "
        f"{({k: v for k, v in counts.items() if v})} as phase 6 "
        f"({CARD}): {time.perf_counter() - t0:.1f} s")
    del summary, model, layer, attention
    all_counts = Counter(counts)

    t0 = time.perf_counter()
    held = _collected_gib()
    job = sample.parse_args(sample_args("ttt_mlp"))
    reset_counts()
    summary = _as_torchrun_rank_0(lambda: sample.main(job))
    counts = read_counts()
    cfg, evals = summary["model_config"], len(summary["eval_seconds"])
    expect = {"ttt_mlp_forward": 2 * cfg.num_layers * evals, "attention_forward": cfg.num_layers * evals}
    if counts != {**dict.fromkeys(counts, 0), **expect} or summary["mesh"] != (1, 1, 1):
        raise AssertionError(f"sampling: launches {counts} (expected {expect}), mesh {summary['mesh']}")
    latents = np.load(summary["latents"][0])
    err = float(np.abs(latents - sampled["latents"]).max())
    if latents.shape != sampled["latents"].shape or not err <= DIST_LATENT_TOL:
        raise AssertionError(f"sampling latents {latents.shape} differ from phase 4's by {err:.4g} > {DIST_LATENT_TOL}")
    steady = summary["eval_seconds"][1:] or summary["eval_seconds"]
    eval_s = sum(steady) / len(steady)
    log(f"phase 13 ttt_mlp 3s sample through torchrun's branch, world 1 (mesh 1 x 1 x 1, heads over tensor) "
        f"{cfg.num_layers} layers, {evals} evals: latents vs phase 4's max abs difference {err:.4g} (tol "
        f"{DIST_LATENT_TOL}), {eval_s:.3f} s/eval after the first vs phase 4's {sampled['eval_seconds']:.3f} "
        f"({100 * (eval_s / sampled['eval_seconds'] - 1):+.2f} %), peak {summary['peak_memory_bytes']['dit'] / 2**30:.2f}"
        f" GiB vs {sampled['peak'] / 2**30:.2f} GiB ({held:.2f} GiB allocated before the run), launches "
        f"{({k: v for k, v in counts.items() if v})} ({CARD}): "
        f"{time.perf_counter() - t0:.1f} s")
    all_counts.update(counts)
    return dict(all_counts)


# Phase 14: the offline data path. Episodes of 49 (3 s) and 193 (12 s, the tool's default, 4 encode windows)
# frames at 480 x 720; 8 annotations; the 2-scene CPU comparisons; the loader's batches.
OFFLINE_DIR = "output/chip_smoke_offline"
EPISODES = {"3s": 49, "12s": 193}
CROP = (49, 64, 96)  # frames, rows, columns of the card-vs-CPU posterior check


def _words(rng, n: int) -> str:
    return " ".join(rng.choice(STORY_WORDS) for _ in range(n)).capitalize() + "."


def phase_offline(device) -> dict[str, int]:
    """Phase 14: pixels -> VAE posterior and T5 embeddings -> JSONL -> loader -> a training step, through the
    port's offline tools (precompute_video's per-episode function, precompute_text's main), the native reader
    and the training entry; then the VAE split over an NCCL group of one. Returns the training step's kernel
    launches."""
    import contextlib
    import random
    from unittest import mock

    import numpy as np
    import torch.distributed as dist

    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.data import dataset, native, precompute_text, precompute_video
    from ttt_video_dit_torch.models import t5
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder
    from ttt_video_dit_torch.models.vae.enc_dec import Decoder3D, Encoder3D

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError(f"the native reader did not build: {native.build_error()}")
    log(f"  native reader (g++ -O2 of data/_native/npy_loader.cpp, -lz) built and loaded: "
        f"{time.perf_counter() - t0:.1f} s")

    # The VAE 1.0 checkpoint with both halves at the published widths, seeded, under the reference's keys.
    torch.manual_seed(19)
    with torch.device(device):
        halves = {"encoder": Encoder3D(VaeModelConfig.get_encoder_config()),
                  "decoder": Decoder3D(VaeModelConfig.get_decoder_config())}
    vae_path = os.path.join(OFFLINE_DIR, "vae.pt")
    os.makedirs(OFFLINE_DIR, exist_ok=True)
    torch.save({"state_dict": {f"{h}.{k}": v.cpu() for h, m in halves.items() for k, v in m.state_dict().items()}},
               vae_path)
    del halves
    gen = torch.Generator(device).manual_seed(20)
    frames = {k: torch.randint(0, 256, (n, 480, 720, 3), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
              for k, n in EPISODES.items()}
    torch.cuda.empty_cache()

    # Encode each episode through the tool's per-episode function.
    vae = VideoAutoencoder.from_torch_checkpoint(vae_path, device=device, halves=("encoder",))
    data_dir = os.path.join(OFFLINE_DIR, "data")
    os.makedirs(data_dir, exist_ok=True)
    posteriors, seconds, peaks = {}, {}, {}
    for name, n in EPISODES.items():
        path = os.path.join(data_dir, f"episode_{name}.npy")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        out = precompute_video.precompute_episode(vae, path, (n - 1) // 4 + 1, lambda: frames[name])
        seconds[name] = time.perf_counter() - t
        peaks[name] = torch.cuda.max_memory_allocated(device)
        want = ((n - 1) // 4 + 1, 32, 60, 90)
        if out is None or out.shape != want or not np.isfinite(out).all() or not np.array_equal(np.load(path), out):
            raise AssertionError(f"{name} episode: posterior {None if out is None else out.shape}, expected finite "
                                 f"{want} written to {path}")
        posteriors[name] = out
    torch.cuda.empty_cache()
    log(f"phase 14 VAE encode through precompute_video.precompute_episode (float32, cuDNN TF32 off), seeded VAE 1.0 "
        "encoder: " + "; ".join(
            f"{name} episode [{n}, 480, 720, 3] uint8 -> {list(posteriors[name].shape)} finite in "
            f"{seconds[name]:.2f} s ({n / seconds[name]:.2f} frames/s), peak {peaks[name] / 2**30:.2f} GiB"
            for name, n in EPISODES.items()) + f" ({CARD})")

    # The card against the CPU on a crop, then a rerun that must skip through validate_existing.
    T, Hc, Wc = CROP
    crop = np.ascontiguousarray(frames["3s"][:T, :Hc, :Wc])
    t = time.perf_counter()
    got = precompute_video.encode_episode(vae, crop)
    want = precompute_video.encode_episode(VideoAutoencoder.from_torch_checkpoint(vae_path, halves=("encoder",)), crop)
    rel, err, scale = (float(np.linalg.norm(got - want) / np.linalg.norm(want)), float(np.abs(got - want).max()),
                       float(np.abs(want).max()))
    if got.shape != want.shape or not rel <= VAE_REL_L2_TOL or err > VAE_MAX_TOL * scale:
        raise AssertionError(f"VAE encode of the {list(crop.shape)} crop, card vs CPU: relative L2 {rel:.4g} "
                             f"(tol {VAE_REL_L2_TOL}), max_abs_err {err:.4g} (tol {VAE_MAX_TOL} x {scale:.4g})")
    log(f"  VAE encode of a {list(crop.shape)} crop -> {list(got.shape)}, card vs CPU float32: relative L2 {rel:.4g} "
        f"(tol {VAE_REL_L2_TOL}), max_abs_err {err:.4g} (tol {VAE_MAX_TOL} x max {scale:.4g}): "
        f"{time.perf_counter() - t:.1f} s")

    def no_read():
        raise AssertionError("a valid posterior was read and encoded again")

    path_3s, unsplit_3s = os.path.join(data_dir, "episode_3s.npy"), posteriors["3s"]
    mean, logvar = unsplit_3s[:, :16], unsplit_3s[:, 16:]
    if not precompute_video.validate_existing(path_3s, 13):  # these seeded weights stay inside the ranges
        raise AssertionError(f"the seeded posterior is outside validate_existing's ranges (mean {mean.min():.3g}.."
                             f"{mean.max():.3g}, log var {logvar.min():.3g}..{logvar.max():.3g})")
    if precompute_video.precompute_episode(vae, path_3s, 13, no_read) is not None:
        raise AssertionError("the rerun did not skip the valid posterior")
    log(f"  rerun of the 3 s episode (mean {mean.min():.3g}..{mean.max():.3g}, log var {logvar.min():.3g}.."
        f"{logvar.max():.3g}): skipped through validate_existing, the frames not read")
    del vae
    torch.cuda.empty_cache()

    # T5-XXL over 8 annotations in the four token modes (phase 7's tokenizer and seeded weights), then the same
    # weights (the scene tokens' rows included) on the CPU on 2 of them in the "both" mode, card against CPU.
    # Then phase 8's 2-layer T5 on 2 annotations at 498 tokens, the length the 3 s train TOML's CS 64 tiles
    # (493 + 13 x 1,350 is not a multiple of 64), for the training step's files.
    rng = random.Random(21)
    annotations = os.path.join(OFFLINE_DIR, "annotations.jsonl")
    scenes = [{"text": _words(rng, rng.randint(150, 260)), "name": f"scene{i}"} for i in range(8)]
    with open(annotations, "w", encoding="utf-8") as f:
        f.write("".join(json.dumps(a) + "\n" for a in scenes))
    with open(os.path.join(OFFLINE_DIR, "annotations2.jsonl"), "w", encoding="utf-8") as f:
        f.write("".join(json.dumps(a) + "\n" for a in scenes[:2]))
    load, held = t5.T5Encoder.load_hf_weights, {}

    def seeded(enc, _dir):
        held["enc"] = enc
        return enc.init_weights_(torch.Generator(enc.shared.weight.device).manual_seed(7))

    t5.T5Encoder.load_hf_weights = seeded
    torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    try:
        xxl_dir = os.path.join(SERVE_DIR, "t5xxl")
        xxl = precompute_text.main(["--t5-dir", xxl_dir, "--input-jsonl", annotations, "--output-path",
                                    os.path.join(OFFLINE_DIR, "text_xxl"), "--max-length", "493", "--video-length",
                                    "3"])
    finally:
        t5.T5Encoder.load_hf_weights = load
    xxl_seconds, xxl_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated(device)
    names = sorted(os.path.relpath(os.path.join(d, n), OFFLINE_DIR) for d in xxl["dirs"] for n in os.listdir(d))
    if xxl["files"] != 32 or len(names) != 32 or xxl["device"] != "cuda:0":
        raise AssertionError(f"precompute_text on {xxl['device']} wrote {xxl['files']} files: {names}")
    batch_ms = [1e3 * b for b in xxl["batch_seconds"]]
    log(f"  precompute_text, T5-XXL (seeded, float32, TF32 off) on 8 annotations at --max-length 493: 32 files in "
        f"4 token-mode directories, {batch_ms[0]:.1f} ms for the first batch of 8 (tokenizer load included), "
        f"{sum(batch_ms[1:]) / 3:.1f} ms a batch of 8 after it, {xxl_seconds:.1f} s with the load, peak "
        f"{xxl_peak / 2**30:.2f} GiB ({CARD})")
    t = time.perf_counter()
    got = np.stack([np.load(os.path.join(xxl["dirs"][1], f"scene{i}_txt_emb.npy")) for i in range(2)])
    enc = held.pop("enc").cpu()
    torch.cuda.empty_cache()
    ids = t5._load_tokenizer(xxl_dir)([precompute_text.apply_token_mode(a["text"], "both") for a in scenes[:2]], 493)
    with torch.inference_mode():
        want = enc(torch.from_numpy(ids).long()).numpy()
    del enc
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if (got.shape != (2, 493, 4096) or want.shape != got.shape or got.dtype != np.float32
            or not np.isfinite(got).all() or not rel <= T5_REL_L2_TOL):
        raise AssertionError(f"precompute_text, T5-XXL, card {got.shape} {got.dtype} vs CPU {want.shape}: relative "
                             f"L2 {rel:.4g} (tol {T5_REL_L2_TOL})")
    log(f"  precompute_text's T5-XXL embeddings of 2 annotations ({xxl['dirs'][1]}, [2, 493, 4096] float32) vs the "
        f"same weights on the CPU, float32: relative L2 {rel:.4g} (tol {T5_REL_L2_TOL}), max_abs_err "
        f"{float(np.abs(got - want).max()):.4g}: {time.perf_counter() - t:.1f} s")
    card = precompute_text.main(["--t5-dir", os.path.join(SERVE_DIR, "t5"), "--input-jsonl",
                                 os.path.join(OFFLINE_DIR, "annotations2.jsonl"), "--max-length", "498",
                                 "--video-length", "3", "--output-path", data_dir])
    if card["files"] != 8:
        raise AssertionError(f"precompute_text, 2-layer T5: {card['files']} files, expected 8")

    # The JSONL metadata: the 3 s posterior with each 498-token embedding; the loader with and without the pool.
    meta = os.path.join(data_dir, "meta.jsonl")
    texts = sorted(os.path.relpath(os.path.join(d, n), data_dir) for d in card["dirs"] for n in os.listdir(d))
    with open(meta, "w", encoding="utf-8") as f:
        f.write("".join(json.dumps({"vid_emb": "episode_3s.npy", "text_chunk_emb": [p]}) + "\n" for p in texts))
    cfg = train.model_config(train.parse_args(train_args("ttt_mlp")))
    taken, loader_s = {}, {}
    for pooled in (True, False):
        with mock.patch.object(native, "available", return_value=False) if not pooled else contextlib.nullcontext():
            module = dataset.DataModule(data_dir, cfg.scale_factor, meta, seed=0)
            if module.native_reader != pooled:
                raise AssertionError(f"DataModule reads natively: {module.native_reader}, expected {pooled}")
            it = module.batches(1)
            taken[pooled] = [next(it) for _ in range(3)]
            it.close()
        loader_s[pooled] = sum(module.load_seconds[:3]) / 3
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(taken[True], taken[False]) for k in ("vid", "text"))
    shapes = {k: list(v.shape) for k, v in taken[True][0].items()}
    if not same or shapes != {"vid": [1, 13, 16, 60, 90], "text": [1, 1, 498, 4096]}:
        raise AssertionError(f"loader: native and Python batches bit-equal {same}, shapes {shapes}")
    log(f"  loader: 3 batches {shapes} through the native pool and in Python bit-equal; {loader_s[True]:.4f} s a "
        f"batch native, {loader_s[False]:.4f} s in Python (worker seconds: reads and the posterior draw)")

    # One training step of the 3 s TOML at 2 layers on the precomputed files, through the training entry.
    flags = ["--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "2", "--training.steps", "1",
             "--training.global_batch_size", "1", "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
             "--training.dataset_path", data_dir, "--training.jsonl_paths", meta, "--checkpoint.interval", "0",
             "--job.dump_folder", os.path.join(OFFLINE_DIR, "run")]
    reset_counts()
    summary = train.main(train.parse_args(flags))
    counts = read_counts()
    L = summary["model_config"].num_layers
    expect = {"ttt_mlp_forward_train": 2 * L, "ttt_mlp_backward": 2 * L, "attention_forward_lse": L,
              "attention_backward": L, "convert_f32_bf16": 2 * 12 * L}
    if counts != {**dict.fromkeys(counts, 0), **expect}:
        raise AssertionError(f"training step: kernel launches {counts}, expected {expect}")
    if not summary["native_reader"] or summary["text_length"] != 498 or not np.isfinite(summary["losses"]).all():
        raise AssertionError(f"training step: native reader {summary['native_reader']}, text length "
                             f"{summary['text_length']}, losses {summary['losses']}")
    log(f"  training step, ttt_mlp 3 s TOML at 2 layers on the precomputed files (native reader in use, text length "
        f"498): loss {summary['losses'][0]:.4f}, grad norm {summary['grad_norms'][0]:.4f}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    del summary
    _collected_gib()

    # The VAE split over an NCCL group of one: the one-device code, so bit-equal to the first encode.
    def split_of_one():
        dist.init_process_group("nccl", device_id=device)
        try:
            vae = VideoAutoencoder.from_torch_checkpoint(vae_path, device=device, halves=("encoder",),
                                                         group=dist.group.WORLD)
            return vae.shard, precompute_video.encode_episode(vae, frames["3s"])
        finally:
            dist.destroy_process_group()

    t = time.perf_counter()
    shard, split = _as_torchrun_rank_0(split_of_one)
    if shard is not None or not np.array_equal(split, unsplit_3s):
        raise AssertionError(f"VAE(group=NCCL group of one): shard {shard}, max |diff| from the unsplit encode "
                             f"{float(np.abs(split - unsplit_3s).max()):.4g}")
    log(f"  VAE(group=NCCL group of one) encode of the 3 s episode bit-equal to the one-device encode (a group of one "
        f"runs the one-device code: parallel/spatial.py is not run here): {time.perf_counter() - t:.1f} s")
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    global CARD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    CARD = smi
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x {torch.cuda.device_count()}; tf32 off")
    phase_build()
    phase_selftest(device)
    log_clocks("before the kernels")
    records = phase_kernels(device)
    log_clocks("after the kernels")
    counts = Counter()
    sampled, trained = {}, {}  # ttt_mlp's phase 4 and phase 6 (save_seq) runs, for phase 13
    for variant in VARIANTS:
        phase_dit(device, variant)
        counts.update(phase_sample(device, variant, keep=sampled if variant == "ttt_mlp" else None))
        log_clocks(f"after {variant} sampling")
        phase_grad(device, variant)
        counts.update(phase_train(device, variant, keep=trained if variant == "ttt_mlp" else None))
        counts.update(phase_train(device, variant, remat_policy="none"))
        log_clocks(f"after {variant} training")
    try:
        phase_t5(device)
        counts.update(phase_serve(device))
        log_clocks("after serving")
        try:
            counts.update(phase_resume(device))
            counts.update(phase_requeue(device))
        finally:
            shutil.rmtree(DATA_DIR, ignore_errors=True)
        phase_long_kernels(device)
        log_clocks("after the long-context kernels")
        board_9s = os.path.join(SERVE_DIR, "storyboard_9s.json")
        fabricated_storyboard(board_9s, scenes=3, seed=18)
        for variant in VARIANTS:
            phase_dit(device, variant, "9s")
            vae = os.path.join(SERVE_DIR, "vae.pt") if variant == "ttt_mlp" else None
            counts.update(phase_long_sample(device, variant, "9s", board_9s, vae))
            counts.update(phase_train(device, variant, length="9s"))
            log_clocks(f"after {variant} 9 s")
        counts.update(phase_long_sample(device, "ttt_mlp", "63s", os.path.join(SERVE_DIR, "storyboard_63s.json")))
        log_clocks("after 63 s sampling")
        counts.update(phase_distributed(device, trained, sampled))
        log_clocks("after the torchrun branch")
        try:
            t0 = time.perf_counter()
            counts.update(phase_offline(device))
            log(f"phase 14 offline data path: {time.perf_counter() - t0:.1f} s")
        finally:
            shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
        counts.update(phase_train(device, "ttt_mlp", length="30s", layers=2, steps=2, phase=15))
        log_clocks("after 30 s training")
    finally:
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    for r in records:
        r["launches"] = counts[r["name"]]
        if not r["launches"]:
            raise AssertionError(f"kernel {r['name']} was not launched on the main path")
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
