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
// Not yet done (later work): wgmma, TMA loads, double-buffered tiles,
// ldmatrix, and returning the log-sum-exp for the backward pass.
//
// Layout: q/k/v/o [BC, S, H, 64] bf16, contiguous (the JAX package's layout).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF = 64;         // head dim
constexpr int kBM = 64;        // q rows per block
constexpr int kBN = 64;        // kv rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 q rows
constexpr int kLds = kF + 8;   // padded shared-memory row stride, in bf16

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A(16x16, row) * B(16x8, col), bf16 inputs, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int S, int H, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBN * kLds];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBN * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment group / thread-in-group
  const int h = blockIdx.y, bc = blockIdx.z;
  const size_t rs = (size_t)H * kF;  // elements between consecutive tokens
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  // Q A-fragments for this warp's 16 rows, kept for the whole kernel.
  const int r0 = blockIdx.x * kBM + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qa[kk][0] = r0 < S ? ld32(qb + r0 * rs + c) : 0u;
    qa[kk][1] = r1 < S ? ld32(qb + r1 * rs + c) : 0u;
    qa[kk][2] = r0 < S ? ld32(qb + r0 * rs + c + 8) : 0u;
    qa[kk][3] = r1 < S ? ld32(qb + r1 * rs + c + 8) : 0u;
  }

  float oacc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[nt][j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows r0 / r1
  float l0 = 0.f, l1 = 0.f;              // this thread's partial row sums

  for (int kv0 = 0; kv0 < S; kv0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBN * (kF / 8); i += kThreads) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < S) {
        kk4 = *reinterpret_cast<const uint4*>(kb + (size_t)(kv0 + r) * rs + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(kv0 + r) * rs + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * kLds + c) = kk4;
      *reinterpret_cast<uint4*>(Vs + r * kLds + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 kv columns (8 n-tiles of 8).
    float sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[nt][j] = 0.f;
      const __nv_bfloat16* krow = Ks + (nt * 8 + g) * kLds + t4 * 2;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma16816(sacc[nt], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // Scale into the log2 domain; mask kv columns past the window.
    const bool ragged = kv0 + kBN > S;
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]);
      pa[1] = pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]);
      pa[2] = pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = Vs + (kk * 16 + t4 * 2) * kLds + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vp = v0 + nt * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[kLds]);
        const uint32_t b1 = pack_raw(vp[8 * kLds], vp[9 * kLds]);
        mma16816(oacc[nt], pa, b0, b1);
      }
    }
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
}

}  // namespace

extern "C" int attention_forward(const void* q, const void* k, const void* v, void* o, int BC, int S, int H,
                                 float scale, void* stream) {
  const dim3 grid((S + kBM - 1) / kBM, H, BC);
  const float scale_log2 = scale * 1.4426950408889634f;
  attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
