// Fused TTT-MLP forward scan in float32 (K1 for sampling, K1-train for
// training: one kernel, K = 0 writes no checkpoints), head_dim F = 64, every
// mini-batch CS of ops/ttt_mlp_kernel.py:KERNEL_MINI_BATCHES, for Hopper
// (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_mlp_kernel (with
// _fused_preproc and _eta_from_gate) at dt = xq_ref.dtype = float32, where
// every `.astype(dt)` before a product is the identity and _bmm keeps float32
// sums: the fused-preprocessing, token-major form of the bf16 kernel
// (ttt_mlp_forward.cu), with its signature and checkpoint layout, and nothing
// rounded to bf16. Per (batch, head) it walks the NC mini-batches in order:
// L2-norm + rope of the raw q/k projections, the LN-reconstruction target from
// v - k, eta = sigmoid(gate) * eta_scale, one dual-form update of the
// 2-layer GELU fast weight (ttt_f32.cuh:mlp_step), and out = XQ + LN(Z2_bar);
// before mini-batch n with n % K == 0 the training launch writes the state as
// checkpoint n / K.
//
// What bounds it on the H100: the operations. A step is 56 CS F^2 + 20 CS^2 F
// flops a head (19.9 Mflop at CS 64), exact float32 products: on the CUDA
// cores at 67 TFLOP/s, or as three TF32 tensor-core passes at 495 / 3 = 165
// (the bound chip_smoke.py states). The scan is sequential, so one block owns
// one (batch, head): 48 or 96 of the 132 SMs at the 3 s shapes.
//
// Design (simple first, ttt_f32.cuh): one block of 256 threads per (batch,
// head); the fp32 state W1 [F][4F], b1, W2 [4F][F], b2 in shared memory
// (132 KiB) beside the staging tiles of the block-wide products (35 KiB); each
// step's [CS][4F] and [CS][F] intermediates in a device-memory workspace of
// the wrapper's (368 KiB a block at CS 64, in the L2). Products are float32
// FMA loops, a 4 x 4 output tile a thread.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*F] f32; gate [B, H, NC, CS] f32
// (pre-sigmoid logits); rope cos/sin [NC, CS, F] f32; ln_w/ln_b [H, F];
// W1 [H, F, 4F], b1 [H, 1, 4F], W2 [H, 4F, F], b2 [H, 1, F] (the initial
// state, shared by every batch element); checkpoints W1 [B, H, NG, F, 4F],
// b1 [B, H, NG, 1, 4F], W2 [B, H, NG, 4F, F], b2 [B, H, NG, 1, F]. Every
// pointer 16-byte aligned.

#include "ttt_f32.cuh"

namespace {

using namespace tttf;

struct Args {
  Scan s;
  const float *W1, *b1, *W2, *b2;
  float* out;
  float *w1_ck, *b1_ck, *w2_ck, *b2_ck;
  float* work;
  int K;  // 0: no checkpoints
};

__global__ void __launch_bounds__(kThreads, 1) ttt_mlp_fwd_f32_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  const State st = state_at(smem, true);
  float* stage = smem + state_floats(true);
  Scan S = A.s;
  S.b = blockIdx.x / S.H, S.h = blockIdx.x % S.H;
  const FwdWork L(S.CS, true);
  float* w = A.work + (size_t)blockIdx.x * L.floats;
  const size_t h = S.h;
  load_state(st, A.W1 + h * kF * kH4, A.b1 + h * kH4, A.W2 + h * kH4 * kF, A.b2 + h * kF, true);
  const int NG = A.K > 0 ? (S.NC + A.K - 1) / A.K : 0;
  for (int n = 0; n < S.NC; ++n) {
    if (A.K > 0 && n % A.K == 0) {
      const size_t g = (size_t)blockIdx.x * NG + n / A.K;
      save_state(st, A.w1_ck + g * kF * kH4, A.b1_ck + g * kH4, A.w2_ck + g * kH4 * kF, A.b2_ck + g * kF, true);
    }
    mlp_step(S, n, st, w, L, stage, A.out);
  }
}

constexpr int kSmemBytes = (state_floats(true) + kStageFloats) * 4;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");

}  // namespace

// Shared memory a block takes at mini-batch cs (the same at every CS; an error code for a CS it is not launched
// for).
extern "C" int ttt_mlp_forward_f32_smem_bytes(int cs) {
  return takes_mini_batch(cs) ? kSmemBytes : -static_cast<int>(cudaErrorInvalidValue);
}

// Floats of one block's workspace at mini-batch cs; the wrapper allocates B * H of them.
extern "C" long long ttt_mlp_forward_f32_workspace_floats(int cs) { return (long long)FwdWork(cs, true).floats; }

// K = 0: sampling, no checkpoints (the checkpoint pointers unused).
extern "C" int ttt_mlp_forward_f32(const void* xq, const void* xk, const void* xv, const void* gate,
                                   const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                   const void* W1, const void* b1, const void* W2, const void* b2, void* out,
                                   void* w1_ck, void* b1_ck, void* w2_ck, void* b2_ck, void* work, int B, int NC, int H,
                                   int CS, int K, float eta_scale, void* stream) {
  if (!takes_mini_batch(CS)) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{Scan{static_cast<const float*>(xq), static_cast<const float*>(xk), static_cast<const float*>(xv),
                    static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                    static_cast<const float*>(rope_sin), static_cast<const float*>(ln_w),
                    static_cast<const float*>(ln_b), NC, H, CS, eta_scale, 0, 0},
               static_cast<const float*>(W1), static_cast<const float*>(b1), static_cast<const float*>(W2),
               static_cast<const float*>(b2), static_cast<float*>(out), static_cast<float*>(w1_ck),
               static_cast<float*>(b1_ck), static_cast<float*>(w2_ck), static_cast<float*>(b2_ck),
               static_cast<float*>(work), K};
  return launch(ttt_mlp_fwd_f32_kernel, B * H, kSmemBytes, stream, A);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
