// Fused TTT-linear forward scan (K5), head_dim F = 64, mini-batch CS = 8,
// 16, ..., 64 (one instantiation each, ttt_mlp_block.cuh:with_slabs), for
// Hopper (sm_90a): sampling (no state checkpoints) and training (fp32 state
// checkpoints every K mini-batches, for csrc/ttt_linear_backward.cu).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_linear_kernel with
// _fused_preproc and _eta_from_gate (launched by ttt_linear_forward, reached
// through ttt_vjp.py:ttt_linear_fused_pre and ttt_linear_kernel.py:
// ttt_linear), in its token-major, fused-preprocessing form. Per (batch,
// head) it walks the NC mini-batches in order: L2-norm + rope of the raw
// q/k projections, the LN-reconstruction target from v - k, eta =
// sigmoid(gate) * eta_scale, one dual-form update of the linear fast weight
// (W [F, F], b [F]; fp32 state), and out = XQ + LN(Z1_bar).
//
// What bounds it on the H100: the scan is sequential in NC, so one block
// owns one (batch, head) and the limit is the latency of one step inside an
// SM: a chain of small dependent products (6 CS F^2 + 4 CS^2 F = 0.46 Mflop a
// step at CS 16, 2.62 at CS 64) and the waits between the warps that share
// it. Device memory is not the limit (a step reads ~6 KiB and writes 2 KiB at
// CS 16; the whole call moves ~0.9 GB at the 3 s sampling shape, 0.27 ms at
// 3.35 TB/s, whatever CS is). At B = 2 the grid is 96 blocks on 132 SMs, at
// B = 1 (training) 48.
//
// Design: ttt_linear_step.cuh's tensor-core step. One block of 8 warps per
// (batch, head): 4 consumer warps keep the fp32 state W^T in mma.sync
// accumulator registers (warp w owns rows 16 w .. 16 w + 15) and run every
// product on the tensor cores, meeting at 3 named barriers a step; the
// producer warpgroup prepares the next mini-batch into a two-stage ring
// while they do (its raw ring has one stage at CS 64, see the header). Before mini-batch n with n % K == 0 the training launch
// writes the state as checkpoint n / K (W transposed back to [F][F] from the
// registers, and b as one row, not the TPU's 8 rows x 0.125) with plain
// stores nobody waits on; the last group may be shorter than K.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*F] bf16 (head h = columns h*F..h*F+F);
// gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope cos/sin [NC, CS, F] f32;
// ln_w/ln_b [H, F] f32; W1 [H, F, F], b1 [H, 1, F] f32 (the initial state,
// shared by every batch element); checkpoints W1 [B, H, NG, F, F], b1
// [B, H, NG, 1, F] f32. Every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_linear_step.cuh"

namespace {

using namespace tttl;

template <int NS>
struct Smem {
  static constexpr int kCS = kSlab * NS;
  RawStage<NS> raw[kRawSlots<NS>];
  PrepStage<NS> prep[2];
  float z[kCS * kLdZ], zb[kCS * kLdZ];
  bf16 gs[kCS * kLdB];
  uint64_t full[2], empty[2];
};
static_assert(sizeof(Smem<1>) <= 232448 && sizeof(Smem<2>) <= 232448 && sizeof(Smem<3>) <= 232448 &&
                  sizeof(Smem<4>) <= 232448,
              "exceeds the 227 KB shared-memory opt-in");

struct Args {
  ScanArgs a;
  const float *ln_w, *ln_b, *W1, *b1;
  bf16* out;
  float *w_ck, *b_ck;
  int K;  // 0: no checkpoints
};

template <int CS>
__global__ void __launch_bounds__(kThreads, 1) ttt_linear_fwd_kernel(const Args A) {
  constexpr int NS = slabs(CS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NS>& S = *reinterpret_cast<Smem<NS>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&S.full[s], 128);        // every producer thread
      hopper::mbar_init(&S.empty[s], kConsumers);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= kWarps) {
    producer<CS>(S.raw, S.prep, S.full, S.empty, A.a, A.ln_w, A.ln_b, b, h, 0, NC, 0, warp - kWarps, lane, nullptr);
    return;
  }
  LinState st;
  load_state(st, A.W1 + (size_t)h * kF * kF, A.b1 + (size_t)h * kF, warp, lane);
  const int f = 8 * (lane & 7);
  float lw[8], lb[8];
  ld_f32(lw, A.ln_w + (size_t)h * kF + f);
  ld_f32(lb, A.ln_b + (size_t)h * kF + f);
  const StepTiles T{S.z, S.gs, S.zb};
  const size_t HF = (size_t)A.a.H * kF;
  const int NG = A.K > 0 ? (NC + A.K - 1) / A.K : 0;
  for (int n = 0; n < NC; ++n) {
    const int s = n & 1;
    if (A.K > 0 && n % A.K == 0) {
      const size_t g = (size_t)bh * NG + n / A.K;
      save_state(st.w, st.bias, A.w_ck + g * kF * kF, A.b_ck + g * kF, warp, lane);
    }
    hopper::mbar_wait(&S.full[s], (n >> 1) & 1);
    step<CS, true, false>(st, S.prep[s], T, lw, lb, A.out + ((size_t)b * NC + n) * CS * HF + (size_t)h * kF, HF,
                          nullptr, nullptr, warp, lane);
    hopper::mbar_arrive(&S.empty[s]);
  }
}

}  // namespace

// Shared memory of the instantiation for mini-batch cs (an error code for a CS it is not built for).
extern "C" int ttt_linear_forward_smem_bytes(int cs) {
  return with_slabs(cs, [](auto c) { return (int)sizeof(Smem<slabs(decltype(c)::value)>); });
}

// K = 0: sampling, no checkpoints (w_ck and b_ck unused).
extern "C" int ttt_linear_forward(const void* xq, const void* xk, const void* xv, const void* gate,
                                  const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                  const void* W1, const void* b1, void* out, void* w_ck, void* b_ck, int B, int NC,
                                  int H, int CS, int K, float eta_scale, void* stream) {
  const Args A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                static_cast<const float*>(rope_sin), NC, H, eta_scale},
               static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
               static_cast<const float*>(b1), static_cast<bf16*>(out), static_cast<float*>(w_ck),
               static_cast<float*>(b_ck), K};
  return with_slabs(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value;
    constexpr int kBytes = sizeof(Smem<slabs(kMiniBatch)>);
    cudaError_t err =
        cudaFuncSetAttribute(ttt_linear_fwd_kernel<kMiniBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ttt_linear_fwd_kernel<kMiniBatch><<<B * H, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
