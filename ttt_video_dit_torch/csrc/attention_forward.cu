// Window attention forward, head_dim 64, for Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/attention.py:_splash_kernel (the splash
// flash-attention forward, reached through _splash_padded / attention() from
// models/dit/dit.py SegmentLocalAttention). It computes, per attention window
// and head, O = softmax(Q K^T / sqrt(F)) V, non-causal, over one window of S
// tokens (18,048 at the 3 s geometry).
//
// What bounds it on the H100: operations. Per window and head it does
// 4 S^2 F flops on 4 S F bf16 inputs and outputs (about 770 flops per byte
// at S = 18,048), far above the ~295 flop/byte ridge, so the tensor cores set
// the limit; the softmax's S^2 exponentials come next (the SM's special
// function units do 16 a clock against 4,096 tensor flops, so at F = 64 they
// take as long as the products unless the two overlap).
//
// Design: a warp-specialised flash forward on TMA, mbarriers and wgmma
// (helpers in hopper.cuh). One block of four warpgroups per (window-batch,
// head, 192-row q tile):
//   - producer warpgroup (setmaxnreg down to 24): one thread loads the
//     192 x 64 Q tile once, then the 128 x 64 K and V tiles of every kv step
//     into a ring of 2 stages, by TMA (4-D tensor maps over [BC, S, H, 64],
//     128-byte swizzle; reads past S come back as zeros), each stage signalled
//     by a "full" mbarrier and handed back by an "empty" one (one arrival per
//     consumer warp);
//   - three consumer warpgroups (setmaxnreg up to 160), 64 q rows each:
//     S = Q K^T by wgmma m64n128k16 (4 k-steps, both operands in shared
//     memory, K-major), an online softmax in fp32 registers in the log2
//     domain (exponentials by ex2.approx.ftz), then O += P V by wgmma
//     m64n64k16 (8 k-steps) with P as bf16 A fragments in registers and V,
//     row-major [kv, F], as the MN-major B. The P V product of kv step j - 1
//     is issued right after S of step j and runs while step j's softmax is
//     computed (two wgmma groups in flight; step 0 is peeled so that every
//     wait sees the same groups, else ptxas serialises the wgmma).
// Per kv step and block: 2 products of 192 x 128 x 64 (4 S^2 F flops over
// the grid); shared memory 24 KB (Q) + 2 stages x 32 KB (K, V) = 88 KB plus
// barriers, dynamic; registers: s 64 + o 32 + P 32 per consumer thread.
// Three consumer warpgroups ran faster than two: more warps hide the softmax.
// The kernel sets the scores of kv columns >= S to -inf and does not store
// q rows >= S, so the caller pads nothing. Given an lse pointer (training),
// it also writes each row's natural-log log-sum-exp of the scaled logits,
// (max + log2(sum)) * ln 2, for the backward (csrc/attention_backward.cu);
// the sampling launch passes none and writes nothing more.
//
// Layout: q/k/v/o [BC, S, H, 64] bf16, contiguous (the JAX package's layout);
// lse [BC, H, S] float32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kF = 64;
constexpr int kConsumers = 3;               // consumer warpgroups, 64 q rows each
constexpr int kBlockQ = 64 * kConsumers;    // q rows per block
constexpr int kBlockKV = 128;               // kv rows per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTileBytes = kBlockKV * kF * 2;  // one K or V stage
constexpr int kQBytes = kBlockQ * kF * 2;
constexpr int kSmemBytes = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * (1 + 2 * kStages);
constexpr float kLn2 = 0.6931471805599453f;

// s = Q K^T for one kv step: the warpgroup's 64 q rows against the stage's
// 128 K rows (both K-major; a k-step of 16 features is 32 bytes further).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t qdesc, const uint8_t* ktile) {
  const uint64_t kdesc = desc_sw128(ktile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n128k16_ss<0, 0>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
  wgmma_commit();
}

// One online-softmax step on the raw scores ``s`` of rows r0 / r0 + 8 of the
// lane (``left`` = kv columns of the step inside the window, from 1): masks
// the columns past it, updates the running maxima m (raw scores) and partial
// row sums l, turns s into exp2(s scale log2 e - m scale log2 e), and
// returns the factors (rows r0, r0 + 8) by which the old sums were scaled.
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
// V the stage's 128 x 64 tile (MN-major B, 16 rows = 2048 bytes a k-step).
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&pa)[32], const uint8_t* vtile) {
  const uint64_t vdesc = desc_sw128(vtile);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_m64n64k16_rs<1>(o, &pa[4 * kk], vdesc + 128 * kk, 1);
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* Ks = smem + kQBytes;  // stage s at s * kTileBytes
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
      tma_load_4d(Qs, &tq, q_full, 0, h, q0, bc);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(Ks + s * kTileBytes, &tk, &full[s], 0, h, j * kBlockKV, bc);
        tma_load_4d(Vs + s * kTileBytes, &tv, &full[s], 0, h, j * kBlockKV, bc);
      }
    }
    return;
  }

  // Consumer warpgroups: cw owns q rows q0 + 64 cw .. + 63; within it, each
  // warp 16 rows, each lane rows r0 = 16 warp + g and r0 + 8 of the wgmma
  // accumulator layout (columns 8 i + 2 t4 + {0, 1} of n8 block i).
  reg_alloc<160>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t qdesc = desc_sw128(Qs + cw * 64 * 128);

  float s[64], acc[32];
  uint32_t pa[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max of the raw scores, rows r0 / r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums of exp2 (scaled scores - max)
  mbar_wait(q_full, 0);

  // Step 0 alone, then every step j issues S_j and P_{j-1} V_{j-1} together, so
  // the number of wgmma groups in flight is the same at every wait.
  mbar_wait(&full[0], 0);
  issue_qk(s, qdesc, Ks);
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax(s, m0, m1, l0, l1, S, t4, scale_log2);
  acc_to_a(pa, s);
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    issue_qk(s, qdesc, Ks + st * kTileBytes);
    issue_pv(acc, pa, Vs + ((j - 1) % kStages) * kTileBytes);
    wgmma_wait<1>();  // S_j is in; P V of step j - 1 may still run
    fence_regs(s);
    const float2 alpha = online_softmax(s, m0, m1, l0, l1, S - j * kBlockKV, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&empty[(j - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[4 * i] *= alpha.x;
      acc[4 * i + 1] *= alpha.x;
      acc[4 * i + 2] *= alpha.y;
      acc[4 * i + 3] *= alpha.y;
    }
    acc_to_a(pa, s);  // P rounded to bf16 as the P V operand
  }
  issue_pv(acc, pa, Vs + ((n_tiles - 1) % kStages) * kTileBytes);
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const size_t rs = (size_t)H * kF;  // elements between consecutive tokens
  const int r0 = q0 + cw * 64 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = o + (size_t)bc * S * rs + (size_t)h * kF;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = i * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) = pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
  }
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((size_t)bc * H + h) * S;
    if (r0 < S) lb[r0] = (m0 * scale_log2 + log2f(l0)) * kLn2;
    if (r1 < S) lb[r1] = (m1 * scale_log2 + log2f(l1)) * kLn2;
  }
}

}  // namespace

extern "C" int attention_forward(const void* q, const void* k, const void* v, void* o, void* lse, int BC, int S,
                                 int H, float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_rows_map(&tq, q, BC, S, H, kBlockQ);
  if (err == 0) err = encode_rows_map(&tk, k, BC, S, H, kBlockKV);
  if (err == 0) err = encode_rows_map(&tv, v, BC, S, H, kBlockKV);
  if (err != 0) return err;
  cudaError_t cerr =
      cudaFuncSetAttribute(attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, BC);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return hopper::error_string(err); }
