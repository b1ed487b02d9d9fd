// mma.sync building blocks of the window-attention kernels
// (attention_forward.cu, attention_backward.cu), head_dim 64, bf16 operands,
// fp32 accumulators, for Hopper (sm_90a).
//
// A block of 4 warps owns 64 rows (16 per warp) of q (or k); each lane holds
// its rows' bf16 operands as m16n8k16 A fragments in registers. The other
// operand is staged 64 rows at a time in shared memory with the row stride
// padded to 72 bf16, which makes the fragment loads bank-conflict free.
// Rows at or past the window length S read as zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kF = 64;         // head dim
constexpr int kBM = 64;        // rows per block tile (q or kv)
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kLds = kF + 8;   // padded shared-memory row stride, in bf16
constexpr float kLog2e = 1.4426950408889634f;

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

// A fragments of 16 rows (r0 = row of lane group g, r1 = r0 + 8) x 64 features
// of a [*, rs]-strided bf16 matrix; rows >= S read as zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4], const __nv_bfloat16* base, size_t rs, int r0,
                                             int S, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t4 * 2;
    a[kk][0] = r0 < S ? ld32(base + r0 * rs + c) : 0u;
    a[kk][1] = r1 < S ? ld32(base + r1 * rs + c) : 0u;
    a[kk][2] = r0 < S ? ld32(base + r0 * rs + c + 8) : 0u;
    a[kk][3] = r1 < S ? ld32(base + r1 * rs + c + 8) : 0u;
  }
}

// Stage rows [row0, row0 + 64) of two [*, rs]-strided bf16 matrices into
// shared memory (row stride kLds); rows >= S are zero.
__device__ __forceinline__ void stage_tiles(__nv_bfloat16* As, __nv_bfloat16* Bs, const __nv_bfloat16* a,
                                            const __nv_bfloat16* b, size_t rs, int row0, int S, int tid) {
  for (int i = tid; i < kBM * (kF / 8); i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      x = *reinterpret_cast<const uint4*>(a + (size_t)(row0 + r) * rs + c);
      y = *reinterpret_cast<const uint4*>(b + (size_t)(row0 + r) * rs + c);
    }
    *reinterpret_cast<uint4*>(As + r * kLds + c) = x;
    *reinterpret_cast<uint4*>(Bs + r * kLds + c) = y;
  }
}

// acc[nt] (16 rows x 8 columns each) += A(16 x 64) * Ts^T, Ts a staged
// [64 rows][kLds] tile whose row n is column n of the product (B(k, n) = Ts[n][k]).
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4], const uint32_t (&a)[4][4], const __nv_bfloat16* Ts,
                                         int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const __nv_bfloat16* row = Ts + (nt * 8 + g) * kLds + t4 * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma16816(acc[nt], a[kk], ld32(row + kk * 16), ld32(row + kk * 16 + 8));
  }
}

// acc[nt] += X(16 x 64, an accumulator-layout fp32 tile rounded to bf16) * Ts,
// Ts a staged [64 rows][kLds] tile with B(k, n) = Ts[k][n].
__device__ __forceinline__ void mma_x_b(float (&acc)[8][4], const float (&x)[8][4], const __nv_bfloat16* Ts, int g,
                                        int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const __nv_bfloat16* t0 = Ts + (kk * 16 + t4 * 2) * kLds + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* tp = t0 + nt * 8;
      mma16816(acc[nt], pa, pack_raw(tp[0], tp[kLds]), pack_raw(tp[8 * kLds], tp[9 * kLds]));
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
}

}  // namespace attn
