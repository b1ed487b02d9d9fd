// Window attention forward, head_dim 64, for Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/attention.py:_splash_kernel (the splash
// flash-attention forward, reached through _splash_padded / attention() from
// models/dit/dit.py SegmentLocalAttention). It computes, per attention window
// and head, O = softmax(Q K^T / sqrt(F)) V, non-causal, over one window of S
// tokens (18,048 at the 3 s geometry).
//
// What bounds it on the H100: arithmetic. Per window and head it does
// 4 S^2 F flops on 3 S F bf16 inputs (about 770 flops per byte at S=18,048),
// far above the ~295 flop/byte ridge, so the tensor cores set the limit.
//
// Design: one block of 4 warps per (window-batch, head, 64-row q tile); each
// warp owns 16 q rows. Q stays in registers as mma.sync A fragments for the
// whole block. The block walks 64-row K/V tiles staged in shared memory (row
// stride padded to 72 bf16, which makes the fragment loads bank-conflict
// free), computes S = Q K^T and O += P V with mma.sync m16n8k16 bf16 -> fp32,
// and keeps an online softmax (running row max and row sum) in fp32
// registers, in the log2 domain. P is rounded to bf16 for the P V product;
// O, the max and the sum stay fp32. The kernel masks KV columns >= S and
// skips the store of q rows >= S itself, so the caller pads nothing.
// Given an lse pointer (training), it also writes each row's natural-log
// log-sum-exp of the scaled logits, (max + log2(sum)) * ln 2, for the
// backward (csrc/attention_backward.cu); the sampling launch passes none
// and writes nothing more.
// Not yet done (later work): wgmma, TMA loads, double-buffered tiles,
// ldmatrix.
//
// Layout: q/k/v/o [BC, S, H, 64] bf16, contiguous (the JAX package's layout);
// lse [BC, H, S] float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBM * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment group / thread-in-group
  const int h = blockIdx.y, bc = blockIdx.z;
  const size_t rs = (size_t)H * kF;  // elements between consecutive tokens
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;

  // Q A-fragments for this warp's 16 rows, kept for the whole kernel.
  const int r0 = blockIdx.x * kBM + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[4][4];
  load_a_frags(qa, q + base, rs, r0, S, t4);

  float oacc[8][4];
  zero(oacc);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows r0 / r1
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  for (int kv0 = 0; kv0 < S; kv0 += kBM) {
    __syncthreads();  // the previous tile's readers are done
    stage_tiles(Ks, Vs, k + base, v + base, rs, kv0, S, tid);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 kv columns (8 n-tiles of 8).
    float sacc[8][4];
    zero(sacc);
    mma_a_bt(sacc, qa, Ks, g, t4);

    // Scale into the log2 domain; mask kv columns past the window.
    const bool ragged = kv0 + kBM > S;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sacc[nt][j] * scale_log2;
        if (ragged && kv0 + nt * 8 + t4 * 2 + (j & 1) >= S) s = -INFINITY;
        sacc[nt][j] = s;
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sacc[nt][0], sacc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[nt][2], sacc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Column kv0 < S is always valid, so the new maxima are finite.
    const float nm0 = fmaxf(m0, mx0), nm1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - nm0), alpha1 = exp2f(m1 - nm1);
    m0 = nm0;
    m1 = nm1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      oacc[nt][0] *= alpha0;
      oacc[nt][1] *= alpha0;
      oacc[nt][2] *= alpha1;
      oacc[nt][3] *= alpha1;
      sacc[nt][0] = exp2f(sacc[nt][0] - nm0);
      sacc[nt][1] = exp2f(sacc[nt][1] - nm0);
      sacc[nt][2] = exp2f(sacc[nt][2] - nm1);
      sacc[nt][3] = exp2f(sacc[nt][3] - nm1);
      l0 += sacc[nt][0] + sacc[nt][1];
      l1 += sacc[nt][2] + sacc[nt][3];
    }

    // O += P V. The S accumulator layout is the A-fragment layout of P.
    mma_x_b(oacc, sacc, Vs, g, t4);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) = pack_bf16(oacc[nt][0] * inv0, oacc[nt][1] * inv0);
    if (r1 < S) *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) = pack_bf16(oacc[nt][2] * inv1, oacc[nt][3] * inv1);
  }
  if (lse != nullptr && t4 == 0) {
    const float ln2 = 0.6931471805599453f;
    float* lb = lse + ((size_t)bc * H + h) * S;
    if (r0 < S) lb[r0] = (m0 + log2f(l0)) * ln2;
    if (r1 < S) lb[r1] = (m1 + log2f(l1)) * ln2;
  }
}

}  // namespace

extern "C" int attention_forward(const void* q, const void* k, const void* v, void* o, void* lse, int BC, int S,
                                 int H, float scale, void* stream) {
  const dim3 grid((S + attn::kBM - 1) / attn::kBM, H, BC);
  const float scale_log2 = scale * attn::kLog2e;
  attention_fwd_kernel<<<grid, attn::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S, H,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
