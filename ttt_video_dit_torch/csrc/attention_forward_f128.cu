// Window attention forward, head_dim 128, for Hopper (sm_90a): for sampling
// (K3@F128) and, writing the log-sum-exp, for training (K3-lse@F128).
//
// Replaces: ttt_video_dit_tpu/ops/attention.py:_splash_kernel at head dim 128
// (the splash flash-attention forward, reached through _splash_padded /
// attention() from models/dit/dit.py SegmentLocalAttention, which the JAX
// package takes for bf16 windows whatever the head dim). It computes, per
// attention window and head, O = softmax(Q K^T / sqrt(128)) V, non-causal,
// over one window of S tokens (18,048 at the 3 s geometry; d3072 at 24 heads
// gives head dim 128).
//
// What bounds it on the H100: operations, as at head dim 64
// (attention_forward.cu): 4 S^2 F flops a window and head on 4 S F bf16
// inputs and outputs, ~1,500 flops a byte at S = 18,048, far above the ~295
// flop/byte ridge. At F = 128 a kv step does twice the products for the same
// S^2 exponentials, so the softmax weighs half as much against the tensor
// cores as at F = 64.
//
// Design: attention_forward.cu's warp-specialised flash forward on TMA,
// mbarriers and wgmma, reshaped for 128-wide rows. A source of its own, so the
// head-dim-64 kernel compiles as before. One block of three warpgroups per
// (window-batch, head, 128-row q tile):
//   - producer warpgroup (setmaxnreg down to 24): one thread loads the
//     128 x 128 Q tile once, then the 128 x 128 K and V tiles of every kv step
//     into a ring of 2 stages, by TMA. The 128-byte swizzle takes boxes of at
//     most 64 bf16 across, so every 128-wide tile is two 64-column halves,
//     each its own box of a 4-D tensor map over [BC, S, H, 128] (reads past S
//     come back as zeros); each stage is signalled by a "full" mbarrier and
//     handed back by an "empty" one (one arrival per consumer warp);
//   - two consumer warpgroups (setmaxnreg up to 240), 64 q rows each:
//     S = Q K^T by wgmma m64n128k16 (8 k-steps: 4 in each half of Q and K,
//     both operands in shared memory, K-major), the online softmax of
//     attention_forward.cu in fp32 registers in the log2 domain, then
//     O += P V by wgmma m64n64k16 (8 k-steps) once per 64-column half of V
//     into two accumulators, with P as bf16 A fragments in registers and V
//     as the MN-major B. As at F = 64, the P V products of kv step j - 1 are
//     issued right after S of step j and run while step j's softmax is
//     computed (two wgmma groups in flight; step 0 peeled).
// Registers: s 64 + o 64 + P 32 a consumer thread; three consumer warpgroups
// would leave ~160 each beside the producer and spill, two at 240 do not (the
// layout FlashAttention-3 uses at head dim 128). 128 x 24 + 256 x 240 =
// 384 x 168, the launch's allocation: setmaxnreg only moves registers within
// it. Shared memory: 32 KB (Q) + 2 stages x 64 KB (K, V) = 160 KB plus
// barriers, dynamic. The kernel sets the scores of kv columns >= S to -inf
// and does not store q rows >= S, so the caller pads nothing.
//
// The training launch (lse not null) also writes lse [BC, H, S] float32 =
// ln(sum exp(q k^T / sqrt(128))) per row, for csrc/attention_backward_f128.cu,
// from the row maxima and sums the consumers already hold. It is a template
// instantiation of its own (kLse), so the sampling kernel compiles as
// without it.
//
// Layout: q/k/v/o [BC, S, H, 128] bf16, contiguous (the JAX package's layout).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f128.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

using attn128::kF;
using attn128::kHalf;
using attn128::load_tile;
constexpr int kConsumers = 2;               // consumer warpgroups, 64 q rows each
constexpr int kBlockQ = 64 * kConsumers;    // q rows per block
constexpr int kBlockKV = 128;               // kv rows per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kHalfBytes = kBlockKV * kHalf * 2;  // one 64-column half of a K or V stage
constexpr int kTileBytes = 2 * kHalfBytes;        // one K or V stage
constexpr int kQHalfBytes = kBlockQ * kHalf * 2;
constexpr int kQBytes = 2 * kQHalfBytes;
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");

// s = Q K^T for one kv step: the warpgroup's 64 q rows against the stage's
// 128 K rows, features 0-63 from the first halves and 64-127 from the second
// (both K-major; a k-step of 16 features is 32 bytes further).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t qd0, uint64_t qd1, const uint8_t* ktile) {
  const uint64_t kd0 = desc_sw128(ktile), kd1 = desc_sw128(ktile + kHalfBytes);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss<0, 0>(s, qd0 + 2 * kk, kd0 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss<0, 0>(s, qd1 + 2 * kk, kd1 + 2 * kk, 1);
  wgmma_commit();
}

// One online-softmax step, as attention_forward.cu's: masks the columns past
// the window (``left`` = kv columns of the step inside it, from 1), updates
// the running maxima m and partial row sums l of rows r0 / r0 + 8, turns s
// into exp2(s scale log2 e - m scale log2 e), and returns the factors by
// which the old sums were scaled.
__device__ __forceinline__ float2 online_softmax(float (&s)[64], float& m0, float& m1, float& l0, float& l1,
                                                 int left, int t4, float scale_log2) {
  if (left < kBlockKV) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (i * 8 + t4 * 2 + (e & 1) >= left) s[4 * i + e] = -INFINITY;
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // The step's first column is always inside the window, so the new maxima are finite.
  const float2 alpha = make_float2(exp2_ftz((m0 - mx0) * scale_log2), exp2_ftz((m1 - mx1) * scale_log2));
  m0 = mx0;
  m1 = mx1;
  const float b0 = mx0 * scale_log2, b1 = mx1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[4 * i] = exp2_ftz(fmaf(s[4 * i], scale_log2, -b0));
    s[4 * i + 1] = exp2_ftz(fmaf(s[4 * i + 1], scale_log2, -b0));
    s[4 * i + 2] = exp2_ftz(fmaf(s[4 * i + 2], scale_log2, -b1));
    s[4 * i + 3] = exp2_ftz(fmaf(s[4 * i + 3], scale_log2, -b1));
    sum0 += s[4 * i] + s[4 * i + 1];
    sum1 += s[4 * i + 2] + s[4 * i + 3];
  }
  l0 = l0 * alpha.x + sum0;
  l1 = l1 * alpha.y + sum1;
  return alpha;
}

// o += P V for one kv step: P the bf16 A fragments of the 64 x 128 scores,
// V the stage's two 128 x 64 halves (MN-major B, 16 rows = 2048 bytes a
// k-step), feature columns 0-63 into o0 and 64-127 into o1.
__device__ __forceinline__ void issue_pv(float (&o0)[32], float (&o1)[32], uint32_t (&pa)[32], const uint8_t* vtile) {
  const uint64_t vd0 = desc_sw128(vtile), vd1 = desc_sw128(vtile + kHalfBytes);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(o0, &pa[4 * kk], vd0 + 128 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(o1, &pa[4 * kk], vd1 + 128 * kk, 1);
  wgmma_commit();
}

__device__ __forceinline__ void rescale(float (&o)[32], float2 alpha) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[4 * i] *= alpha.x;
    o[4 * i + 1] *= alpha.x;
    o[4 * i + 2] *= alpha.y;
    o[4 * i + 3] *= alpha.y;
  }
}

// Rows r0 / r1 of one 64-column half of the output (columns c0 ..), divided by their row sums.
__device__ __forceinline__ void store_half(__nv_bfloat16* ob, const float (&o)[32], int r0, int r1, int S, size_t rs,
                                           int c0, int t4, float inv0, float inv1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + i * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (r1 < S) *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) = pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_f128_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int S, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;            // half 0 (features 0-63), then half 1
  uint8_t* Ks = smem + kQBytes;  // stage s at s * kTileBytes, its halves kHalfBytes apart
  uint8_t* Vs = Ks + kStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * kTileBytes);
  uint64_t* full = q_full + 1;         // a stage's K and V have landed
  uint64_t* empty = full + kStages;    // every consumer warp is done with a stage

  const int tid = threadIdx.x;
  const int h = blockIdx.y, bc = blockIdx.z, q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (S + kBlockKV - 1) / kBlockKV;

  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, kQBytes);
      load_tile(Qs, &tq, q_full, h, q0, bc, kQHalfBytes);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        load_tile(Ks + s * kTileBytes, &tk, &full[s], h, j * kBlockKV, bc, kHalfBytes);
        load_tile(Vs + s * kTileBytes, &tv, &full[s], h, j * kBlockKV, bc, kHalfBytes);
      }
    }
    return;
  }

  // Consumer warpgroups: cw owns q rows q0 + 64 cw .. + 63; within it, each
  // warp 16 rows, each lane rows r0 = 16 warp + g and r0 + 8 of the wgmma
  // accumulator layout (columns 8 i + 2 t4 + {0, 1} of n8 block i).
  reg_alloc<240>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t qd0 = desc_sw128(Qs + cw * 64 * 128), qd1 = desc_sw128(Qs + kQHalfBytes + cw * 64 * 128);

  float s[64], acc0[32], acc1[32];
  uint32_t pa[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max of the raw scores, rows r0 / r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums of exp2 (scaled scores - max)
  mbar_wait(q_full, 0);

  // Step 0 alone, then every step j issues S_j and P_{j-1} V_{j-1} together, so
  // the number of wgmma groups in flight is the same at every wait.
  mbar_wait(&full[0], 0);
  issue_qk(s, qd0, qd1, Ks);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax(s, m0, m1, l0, l1, S, t4, scale_log2);
  acc_to_a(pa, s);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    issue_qk(s, qd0, qd1, Ks + st * kTileBytes);
    issue_pv(acc0, acc1, pa, Vs + ((j - 1) % kStages) * kTileBytes);
    wgmma_wait<1>();  // S_j is in; P V of step j - 1 may still run
    fence_regs(s);
    const float2 alpha = online_softmax(s, m0, m1, l0, l1, S - j * kBlockKV, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
    rescale(acc0, alpha);
    rescale(acc1, alpha);
    acc_to_a(pa, s);  // P rounded to bf16 as the P V operand
  }
  issue_pv(acc0, acc1, pa, Vs + ((n_tiles - 1) % kStages) * kTileBytes);
  wgmma_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const size_t rs = (size_t)H * kF;  // elements between consecutive tokens
  const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)bc * S * rs + (size_t)h * kF;
  store_half(ob, acc0, r0, r1, S, rs, 0, t4, inv0, inv1);
  store_half(ob, acc1, r0, r1, S, rs, kHalf, t4, inv0, inv1);
  if constexpr (kLse) {
    if (t4 == 0) {
      float* lb = lse + ((size_t)bc * H + h) * S;
      if (r0 < S) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
      if (r1 < S) lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
    }
  }
}

template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int BC, int S, int H, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = attn128::encode_half_rows_map(&tq, q, BC, S, H, kBlockQ);
  if (err == 0) err = attn128::encode_half_rows_map(&tk, k, BC, S, H, kBlockKV);
  if (err == 0) err = attn128::encode_half_rows_map(&tv, v, BC, S, H, kBlockKV);
  if (err != 0) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(attention_fwd_f128_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, BC);
  attention_fwd_f128_kernel<kLse><<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int attention_forward_f128_smem_bytes() { return kSmemBytes; }

// lse null: the sampling kernel (no log-sum-exp); else the training one, writing lse [BC, H, S] float32.
extern "C" int attention_forward_f128(const void* q, const void* k, const void* v, void* o, void* lse, int BC, int S,
                                      int H, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return lse == nullptr ? launch<false>(q, k, v, o, lse, BC, S, H, scale, st)
                        : launch<true>(q, k, v, o, lse, BC, S, H, scale, st);
}

extern "C" const char* error_string(int err) { return hopper::error_string(err); }
