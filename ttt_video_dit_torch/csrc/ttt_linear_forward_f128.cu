// Fused TTT-linear forward scan, head_dim F = 128, mini-batch CS = 16, bf16
// q/k/v, for Hopper (sm_90a): sampling (K5@F128, no state checkpoints) and
// training (K5-train@F128: fp32 state checkpoints every K mini-batches, for
// csrc/ttt_linear_backward_f128.cu).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_linear_kernel with
// _fused_preproc and _eta_from_gate at head dim 128 (d3072 at 24 heads),
// which the JAX package takes at any F % 8 == 0. It computes what
// ttt_linear_forward.cu computes at F = 64: per (batch, head) it walks the NC
// mini-batches in order: L2-norm + rope of the raw q/k projections, the
// LN-reconstruction target from v - k, eta = sigmoid(gate) * eta_scale, one
// dual-form update of the linear fast weight (W [F, F], b [F]; fp32 state),
// and out = XQ + LN(Z1_bar).
//
// What bounds it on the H100: as at F = 64, the latency of one step inside an
// SM (the scan is sequential in NC, one block owns one (batch, head)): a chain
// of small dependent products, 6 CS F^2 + 4 CS^2 F = 1.7 Mflop a step at
// CS 16, four times F = 64's products on the same tokens. Device memory is not
// the limit: the sampling call moves the same ~0.89 GB of q/k/v/out as at
// F = 64 with 48 heads (0.27 ms at 3.35 TB/s); the training call at B = 1 and
// K = 4 moves ~0.44 GB of q/k/v/out and ~0.44 GB of checkpoints (the state is
// 64 KiB a head, four times F = 64's). At B = 2 and 24 heads the grid is 48
// blocks on 132 SMs, at B = 1 (training) 24.
//
// Design: ttt_linear_f128.cuh's tensor-core step (8 consumer warps holding
// W^T in mma.sync accumulators, 4 producer warps preparing the next
// mini-batch). Shared memory at CS 16: 2 raw stages of 28 KiB (bf16 q/k/v,
// fp32 rope rows), 2 prepared ones of 17 KiB, the step's tiles 21 KiB:
// 111 KiB. The training launch (K > 0) writes the state as checkpoint n / K
// before mini-batch n with n % K == 0 (each consumer warp stores its own 16
// rows of W^T from its accumulators, transposed back to [F][F], and b as one
// row), plain stores nobody waits on; the last group may be shorter than K.
// It is a template instantiation of its own (kCheckpoints), so the sampling
// kernel compiles as without it.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*128] bf16 (head h = columns
// 128 h .. 128 h + 127); gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope
// cos/sin [NC, CS, 128] f32; ln_w/ln_b [H, 128] f32; W1 [H, 128, 128], b1
// [H, 1, 128] f32 (the initial state, shared by every batch element);
// checkpoints W1 [B, H, NG, 128, 128], b1 [B, H, NG, 1, 128] f32. Every
// pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_linear_f128.cuh"

namespace {

using namespace tttl128;

template <int NS>
struct Smem {
  static constexpr int kCS = kSlab * NS;
  RawStage<NS> raw[2];
  PrepStage<NS> prep[2];
  float z[kCS * kLdZ], zb[kCS * kLdZ];
  bf16 gs[kCS * kLdB];
  uint64_t full[2], empty[2];
};
static_assert(sizeof(Smem<1>) <= 232448, "exceeds the 227 KB shared-memory opt-in");

struct Args {
  ScanArgs a;
  const float *ln_w, *ln_b, *W1, *b1;
  bf16* out;
  float *w_ck, *b_ck;
  int K;  // 0: no checkpoints
};

template <int CS, bool kCheckpoints>
__global__ void __launch_bounds__(kThreads, 1) ttt_linear_fwd_f128_kernel(const Args A) {
  constexpr int NS = CS / kSlab;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NS>& S = *reinterpret_cast<Smem<NS>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&S.full[s], kProducers);  // every producer thread
      hopper::mbar_init(&S.empty[s], kConsumers);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= kWarps) {
    producer<CS, false>(S.raw, S.prep, S.full, S.empty, A.a, A.ln_w, A.ln_b, b, h, 0, NC, 0, warp - kWarps, lane,
                        nullptr);
    return;
  }
  LinState st;
  load_state(st, A.W1 + (size_t)h * kF * kF, A.b1 + (size_t)h * kF, warp, lane);
  const int f = 8 * (lane % kRowLanes);
  float lw[8], lb[8];
  ld_f32(lw, A.ln_w + (size_t)h * kF + f);
  ld_f32(lb, A.ln_b + (size_t)h * kF + f);
  const size_t HF = (size_t)A.a.H * kF;
  for (int n = 0; n < NC; ++n) {
    const int s = n & 1;
    if constexpr (kCheckpoints) {
      if (n % A.K == 0) {
        const size_t g = (size_t)bh * ((NC + A.K - 1) / A.K) + n / A.K;
        save_state(st.w, st.bias, A.w_ck + g * kF * kF, A.b_ck + g * kF, warp, lane);
      }
    }
    hopper::mbar_wait(&S.full[s], (n >> 1) & 1);
    step<CS, true, false>(st, S.prep[s], S, lw, lb, A.out + ((size_t)b * NC + n) * CS * HF + (size_t)h * kF, HF,
                          nullptr, nullptr, warp, lane);
    hopper::mbar_arrive(&S.empty[s]);
  }
}

template <int CS, bool kCheckpoints>
int launch(const Args& A, int B, cudaStream_t stream) {
  constexpr int kBytes = sizeof(Smem<CS / kSlab>);
  cudaError_t err = cudaFuncSetAttribute(ttt_linear_fwd_f128_kernel<CS, kCheckpoints>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ttt_linear_fwd_f128_kernel<CS, kCheckpoints><<<B * A.a.H, kThreads, kBytes, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of the instantiation for mini-batch cs (an error code for a CS it is not built for).
extern "C" int ttt_linear_forward_f128_smem_bytes(int cs) {
  return with_mini_batch(cs, [](auto c) { return (int)sizeof(Smem<decltype(c)::value / kSlab>); });
}

// K = 0: sampling, no checkpoints (w_ck and b_ck unused); K > 0: training, checkpoints every K mini-batches.
extern "C" int ttt_linear_forward_f128(const void* xq, const void* xk, const void* xv, const void* gate,
                                       const void* rope_cos, const void* rope_sin, const void* ln_w,
                                       const void* ln_b, const void* W1, const void* b1, void* out, void* w_ck,
                                       void* b_ck, int B, int NC, int H, int CS, int K, float eta_scale,
                                       void* stream) {
  const Args A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                static_cast<const float*>(rope_sin), NC, H, eta_scale},
               static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
               static_cast<const float*>(b1), static_cast<bf16*>(out), static_cast<float*>(w_ck),
               static_cast<float*>(b_ck), K};
  auto st = static_cast<cudaStream_t>(stream);
  return with_mini_batch(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value;
    return K > 0 ? launch<kMiniBatch, true>(A, B, st) : launch<kMiniBatch, false>(A, B, st);
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
