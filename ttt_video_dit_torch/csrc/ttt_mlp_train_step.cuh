// The TTT-MLP training step at mini-batch CS = 8, 16, ..., 64 (NS =
// ceil(CS / 16) slabs of 16 tokens, ttt_mlp_block.cuh:slabs), head_dim F = 64,
// on the tensor cores, for Hopper (sm_90a). Shared by K1-train
// (ttt_mlp_forward.cu:ttt_mlp_fwd_train_kernel, with the output; also K1 at
// every CS but 16) and K2's pass A (ttt_mlp_backward.cu, state advance only),
// and the fragment loaders K2's pass B uses. Every piece that reads or writes
// device memory is a template on CS, the tile shapes on NS;
// ttt_mlp_block.cuh:with_slabs instantiates the eight values.
//
// One block owns one (batch, head) scan: 8 consumer warps (256 threads) run
// the step, a producer warpgroup (4 warps) prepares the next mini-batch.
//
// - The fp32 state lives in the consumers' registers in the mma.sync
//   m16n8k16 accumulator layout, as in the sampling kernel: warp w owns hidden
//   units 32w..32w+31, the matching 32 rows of W1^T and of W2 (128 registers
//   a thread; State below). The bf16 pairs of W1^T are the B fragments of
//   XK W1 and XQ W1, those of W2 the B fragments of grad_z2 W2^T; the updates
//   W1^T -= G1^T XK and W2 -= X2c^T G2 accumulate into the same registers.
// - The CS tokens are NS 16-row slabs. Products over the warp's own units
//   (Z1, grad_z2 W2^T, Z1_bar) run slab by slab with the B operand from the
//   state. Products that sum over all 256 units (Z2, Z2_bar, attn2) read bf16
//   tiles from shared memory: X2c and X2_barc [CS][256], and a bf16 copy of
//   W2 [256][64] that each warp refreshes from its registers after the update;
//   warp w computes the 16 x 32 output block (rows 16 (w / 2), columns
//   32 (w % 2)), so no partial sums are reduced across warps. Those are 2 NS
//   blocks: at CS 64 every warp has one, below it warps 2 NS..7 skip the
//   product (owns_block) and wait at the next barrier. gelu'(Z1) is
//   recomputed with Z1 where G1 needs it (the 64 KiB it would take in shared
//   memory at CS 64 do not fit beside the tiles).
// - Row passes (the LayerNorms and their VJPs) take CS / 8 rows a warp.
// - Operands are rounded to bf16 exactly where _mlp_kernel calls
//   .astype(dt) (XQ/XK, every W, X2c, bf16(grad_z2), G2, G1, attn1, attn2,
//   X2_barc); only the fp32 summation order differs from the plain version.
// - Every bf16 tile in shared memory pads its rows by 16 bytes, so ldmatrix
//   of 8 rows at one column hits 8 different banks.
// - G1 goes to a [CS][256] tile in shared memory too (32 registers of its
//   fragments spilled when held), read back as the B operand of attn1 G1
//   and, transposed, as the A operand of the W1 update. attn1 and attn2 are
//   recomputed as A fragments, 16 tokens at a time, where Z1_bar and Z2_bar
//   need them, rather than stored.
// - Waits among the consumers, by named barrier: with the output 5 a step
//   (X2c written; Z2 written; grad_z2 and G2 written; X2_barc written;
//   Z2_bar written), without it 3.
// - A half slab (CS 8, 24, 40, 56): the tiles keep 16 NS rows, device memory
//   is addressed with CS. The producer reads only the CS real rows and
//   prepares the padding as XQ = XK = 0, target 0 and eta 0, so its G1 and G2
//   rows are 0 and it adds nothing to b1, b2, W1, W2 or the attn products;
//   the padding's Z1, X2c and grad_z2 are finite and multiplied by those
//   zeros. No padded row is stored. At a multiple of 16 the masking is not
//   compiled.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"

namespace ttts {

using bf16 = __nv_bfloat16;
using hopper::mma_bf16_16816;
using hopper::pack_bf16;
using tttb::slabs;
using tttb::warp_sum;
using tttb::with_slabs;

constexpr int kF = 64;
constexpr int kF4 = 4 * kF;
constexpr int kSlab = 16;               // tokens a slab (one m16 tile)
constexpr int kWarps = 8;                // consumer warps
constexpr int kConsumers = 32 * kWarps;  // consumer threads
constexpr int kThreads = kConsumers + 128;
// setmaxnreg moves registers from the producers to the consumers within the 168 x 384 allocated at launch:
// 256 x 232 + 128 x 40 = 64,512.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kConsumerBar = 1;
constexpr int kLdZ = kF + 4;  // row stride of the fp32 [CS][F] row buffers
constexpr uint32_t kSignBits = 0x80008000u;

// Whether a mini-batch of CS tokens ends in a half slab (tile rows CS .. 16 NS - 1 are padding).
template <int CS>
constexpr bool kHalf = CS % kSlab != 0;

// Whether consumer warp ``warp`` computes a 16 x 32 block of a [CS][F] result (2 NS blocks; all 8 warps at
// CS 64, where the test is not compiled).
template <int NS>
__device__ __forceinline__ bool owns_block(int warp) { return NS == kWarps / 2 || warp < 2 * NS; }

// bf16 tiles in shared memory hold rows of L elements padded to L + 8 (16 bytes more), so that ldmatrix of 8
// rows at one column hits 8 different banks; every offset of a step's fragment loads is then a constant from
// one per-lane base, which keeps the addresses out of the registers (a swizzle took 4 per tile and spilled).
template <int L>
__host__ __device__ constexpr int pitch() { return L + 8; }

template <int L>
__host__ __device__ constexpr int tile_elems(int rows) { return rows * pitch<L>(); }

// Element offset of (r, c) in a padded bf16 tile whose rows hold L elements.
template <int L>
__device__ __forceinline__ int swz(int r, int c) {
  return r * pitch<L>() + c;
}

// A fragment (16 x 16) at rows r0.., columns k0.. of a row-major padded tile.
template <int L>
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int r0, int k0, int lane) {
  hopper::ldsm_x4(a, t + swz<L>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, k0 + (lane >> 4) * 8));
}

// A fragment of X^T at rows m0.., columns k0.., from a row-major padded tile X [k][m].
template <int L>
__device__ __forceinline__ void lda_t(uint32_t (&a)[4], const bf16* t, int m0, int k0, int lane) {
  hopper::ldsm_x4_trans(a, t + swz<L>(k0 + (lane & 7) + (lane >> 4) * 8, m0 + ((lane >> 3) & 1) * 8));
}

// B fragments of k-tile k0 and n-tiles n0, n0 + 8 (b[0], b[1] and b[2], b[3]) from a padded [k][n] tile.
template <int L>
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0, int lane) {
  hopper::ldsm_x4_trans(b, t + swz<L>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8));
}

// The same from a padded [n][k] tile (B = the tile transposed).
template <int L>
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t, int n0, int k0, int lane) {
  hopper::ldsm_x4(b, t + swz<L>(n0 + (lane & 7) + (lane >> 4) * 8, k0 + ((lane >> 3) & 1) * 8));
}

__device__ __forceinline__ void negate(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] ^= kSignBits;
}

// acc (the warp's 16 x 32 block at rows r0, columns c0) += A [.., K] @ B, A a row-major tile of rows LA,
// B a [K][..] tile of rows LB (kBT: B stored [n][k], i.e. the product takes the tile's transpose).
template <int K, int LA, int LB, bool kBT>
__device__ __forceinline__ void block_mm(float (&acc)[4][4], const bf16* A, int r0, const bf16* B, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    lda<LA>(a, A, r0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      if (kBT) ldb_nk<LB>(b, B, c0 + 16 * np, 16 * kk, lane);
      else ldb_kn<LB>(b, B, 16 * kk, c0 + 16 * np, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's 16 x 32 block: fp32 into a [.][ld] row buffer, or rounded into a padded bf16 tile.
__device__ __forceinline__ void store_block(float* dst, int ld, const float (&acc)[4][4], int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(dst + (r0 + g) * ld + c0 + 8 * nt + 2 * t) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(dst + (r0 + g + 8) * ld + c0 + 8 * nt + 2 * t) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ---- the state and the products over a warp's own hidden units
// Warp w, lane = 4 g + t. w[m][f][..]: rows j = 32 w + 16 m + g (elements 0, 1) and + 8 (2, 3) of W1^T (or W2),
// features 8 f + 2t, 8 f + 2t + 1. Per-token products over the warp's units, one slab ([16 tokens] x [32 units]):
// acc[u] n-tile u (units 8 u + 2t, + 1), rows g (0, 1) and g + 8 (2, 3).
struct State {
  float w1[2][8][4], w2[2][8][4];  // W1^T and W2 rows of the warp's units
  float2 b2;                       // b2 of features 2 lane, 2 lane + 1
};

// b1 of units 32 w + 8 u + 2t, + 1 from the fp32 [4F] vector in shared memory (the state's b1 stays there, not
// in the registers; a warp writes only its own units).
__device__ __forceinline__ float2 b1_pair(const float* b1, int warp, int u, int lane) {
  return *reinterpret_cast<const float2*>(b1 + 32 * warp + 8 * u + 2 * (lane & 3));
}

template <typename T>
__device__ __forceinline__ uint32_t state_b(const T (&w)[2][8][4], int u, int f) {
  const int m = u >> 1, half = (u & 1) * 2;
  return pack_bf16(w[m][f][half], w[m][f][half + 1]);
}

// acc[u] += X[slab rows, 0..63] @ bf16(W)[:, units of n-tile u0 + u], X a padded [CS][F] tile; with W = W1^T
// this is X W1, with W = W2 it is X W2^T.
template <int NU = 4, bool kNeg = false>
__device__ __forceinline__ void slab_by_state(float (&acc)[NU][4], const bf16* X, int s, const float (&w)[2][8][4],
                                              int lane, int u0 = 0) {
#pragma unroll
  for (int kk = 0; kk < kF / 16; ++kk) {
    uint32_t a[4];
    lda<kF>(a, X, 16 * s, 16 * kk, lane);
    if (kNeg) negate(a);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      mma_bf16_16816(acc[u], a, state_b(w, u0 + u, 2 * kk), state_b(w, u0 + u, 2 * kk + 1));
  }
}

// w[m][..] += A_m @ Y[16 k0.., 0..63]: a[m] the A fragment (16 units x 16 tokens) of row tile m, Y a padded
// [CS][F] tile (token-major) as B.
__device__ __forceinline__ void update_rows(float (&w)[2][8][4], const uint32_t (&a)[2][4], const bf16* Y, int k0,
                                            int lane) {
#pragma unroll
  for (int fp = 0; fp < kF / 16; ++fp) {
    uint32_t bb[4];
    ldb_kn<kF>(bb, Y, k0, 16 * fp, lane);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_bf16_16816(w[m][2 * fp], a[m], bb[0], bb[1]);
      mma_bf16_16816(w[m][2 * fp + 1], a[m], bb[2], bb[3]);
    }
  }
}

// Store a slab's [16 tokens] x [32 units] values, rounded, into a padded [CS][4F] tile.
__device__ __forceinline__ void store_slab(bf16* dst, const uint32_t (&x)[4][2], int s, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = 32 * warp + 8 * u + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + swz<kF4>(16 * s + g, c)) = x[u][0];
    *reinterpret_cast<uint32_t*>(dst + swz<kF4>(16 * s + g + 8, c)) = x[u][1];
  }
}

// Write the warp's rows of bf16(W) into a padded [4F][F] tile.
__device__ __forceinline__ void store_state_rows(bf16* dst, const float (&w)[2][8][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(dst + swz<kF>(32 * warp + 16 * m + g + 8 * hr, 8 * f + 2 * t)) =
            pack_bf16(w[m][f][2 * hr], w[m][f][2 * hr + 1]);
}

// Keep the compiler from holding packed copies of the state across phases (64 more registers).
template <int A, int B, int C>
__device__ __forceinline__ void fence_state(float (&w)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) asm volatile("" : "+f"(w[i][j][k]));
}

// ---- building blocks of K2's pass B
// acc[u] += (+-) X[slab s rows, 0..63] @ Wt[the warp's units, 0..63]^T, Wt a padded unit-major [4F][F] tile
// (bf16(W1^T) gives X W1, bf16(W2) gives X W2^T).
template <bool kNeg = false>
__device__ __forceinline__ void unit_mm_w(float (&acc)[4][4], const bf16* X, int s, const bf16* Wt, int warp,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < kF / 16; ++kk) {
    uint32_t a[4];
    lda<kF>(a, X, 16 * s, 16 * kk, lane);
    if (kNeg) negate(a);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldb_nk<kF>(b, Wt, 32 * warp + 16 * np, 16 * kk, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// a: the A fragment (k-tile kt) of bf16(+-X[16 s.., :] @ Y^T), i.e. columns 16 kt.. of rows 16 s.. of a [CS][CS]
// product of two padded token-major tiles with rows of LK elements (attn1 = XQ XK^T, attn2 = X2_barc X2c^T, their
// transposes, dA1, dA2). Recomputed where a product needs it rather than stored: one k-tile at a time keeps 8
// accumulators live instead of 32.
template <int LK>
__device__ __forceinline__ void xyt_block(uint32_t (&a)[4], const bf16* X, const bf16* Y, int s, int kt, bool neg,
                                          int lane) {
  float acc[2][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < LK / 16; ++kk) {
    uint32_t xa[4], b[4];
    lda<LK>(xa, X, 16 * s, 16 * kk, lane);
    ldb_nk<LK>(b, Y, 16 * kt, 16 * kk, lane);
    mma_bf16_16816(acc[0], xa, b[0], b[1]);
    mma_bf16_16816(acc[1], xa, b[2], b[3]);
  }
  const float sg = neg ? -1.f : 1.f;
  a[0] = pack_bf16(sg * acc[0][0], sg * acc[0][1]);
  a[1] = pack_bf16(sg * acc[0][2], sg * acc[0][3]);
  a[2] = pack_bf16(sg * acc[1][0], sg * acc[1][1]);
  a[3] = pack_bf16(sg * acc[1][2], sg * acc[1][3]);
}

// acc[u] += bf16(+-X[16 s..] @ Y^T) @ Z[0..CS-1, the warp's units], Z a padded token-major [CS][4F] tile.
template <int LK, int NS>
__device__ __forceinline__ void unit_mm_xyt(float (&acc)[4][4], const bf16* X, const bf16* Y, int s, bool neg,
                                            const bf16* Z, int warp, int lane) {
#pragma unroll 1
  for (int kt = 0; kt < NS; ++kt) {
    uint32_t a[4];
    xyt_block<LK>(a, X, Y, s, kt, neg, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldb_kn<kF4>(b, Z, 16 * kt, 32 * warp + 16 * np, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (the warp's 16 x 32 block, rows 16 s.., columns c0..) += bf16(+-X[16 s..] @ Y^T) @ Z, Z a padded [CS][F] tile.
template <int LK, int NS>
__device__ __forceinline__ void block_mm_xyt(float (&acc)[4][4], const bf16* X, const bf16* Y, int s, bool neg,
                                             const bf16* Z, int c0, int lane) {
#pragma unroll 1
  for (int kt = 0; kt < NS; ++kt) {
    uint32_t a[4];
    xyt_block<LK>(a, X, Y, s, kt, neg, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldb_kn<kF>(b, Z, 16 * kt, c0 + 16 * np, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// d[m][..] += (+-) X^T[the warp's units, tokens] @ Y: X a padded token-major [CS][4F] tile, Y a padded [CS][F]
// tile (the update-shaped products: W -= X^T G, and the gradient carries).
template <int NS, bool kNeg = false>
__device__ __forceinline__ void rows_update(float (&d)[2][8][4], const bf16* X, const bf16* Y, int warp, int lane) {
#pragma unroll
  for (int sk = 0; sk < NS; ++sk) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      lda_t<kF4>(a[m], X, 32 * warp + 16 * m, 16 * sk, lane);
      if (kNeg) negate(a[m]);
    }
    update_rows(d, a, Y, 16 * sk, lane);
  }
}

// A [4F][F] bf16 tile without padding (it must fit a [CS][4F] padded buffer): the 16-byte chunk c of row r lies at
// chunk c ^ (r % 8).
__device__ __forceinline__ int swz_rows(int r, int c) { return r * kF + ((((c >> 3) ^ r) & 7) << 3) + (c & 7); }

__device__ __forceinline__ void store_state_rows_sw(bf16* dst, const float (&w)[2][8][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(dst + swz_rows(32 * warp + 16 * m + g + 8 * hr, 8 * f + 2 * t)) =
            pack_bf16(w[m][f][2 * hr], w[m][f][2 * hr + 1]);
}

// acc (the warp's 16 x 32 block) += (+-) A[rows r0.., 0..255] @ Wsw, A a padded [CS][4F] tile, Wsw such a tile.
template <bool kNeg>
__device__ __forceinline__ void block_mm_sw(float (&acc)[4][4], const bf16* A, int r0, const bf16* Wsw, int c0,
                                            int lane) {
#pragma unroll 2
  for (int kk = 0; kk < kF4 / 16; ++kk) {
    uint32_t a[4];
    lda<kF4>(a, A, r0, 16 * kk, lane);
    if (kNeg) negate(a);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      hopper::ldsm_x4_trans(b, Wsw + swz_rows(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                                              c0 + 16 * np + (lane >> 4) * 8));
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// ---- the producer's preparation of one mini-batch
// What a step reads besides its own tiles. xq, xk: bf16(XQ), bf16(XK) after preprocessing, padded [CS][F] in
// shared memory; tgt: the LN-reconstruction target, row-major [CS][F] fp32; eta = sigmoid(gate) * eta_scale. The
// backward also keeps t_hat [CS][F], the target's std s_t and sigmoid(gate) (sig).
struct Prep {
  bf16 *xq, *xk;
  float *tgt, *eta;
  float *t_hat, *s_t, *sig;  // null in the forward
};

// L2-norm, rope, target LN and eta of rows kRows pw .. kRows (pw + 1) - 1 of mini-batch n (lane: features
// 2 lane, + 1). A half slab's padding gets XQ = XK = 0, target 0 and eta 0 (t_hat 0, its std 1, sigmoid 0).
template <int CS, int kRows>
__device__ __forceinline__ void prepare_rows(const Prep& p, const tttb::ScanArgs& a, const float* ln_w,
                                             const float* ln_b, int b, int h, int n, int pw, int lane) {
  static_assert(kRows <= 32, "one lane a row for eta");
  const int f0 = 2 * lane;
  const size_t HF = (size_t)a.H * kF;
  const float2 lw = *reinterpret_cast<const float2*>(ln_w + (size_t)h * kF + f0);
  const float2 lb = *reinterpret_cast<const float2*>(ln_b + (size_t)h * kF + f0);
#pragma unroll 1
  for (int row = kRows * pw; row < kRows * (pw + 1); ++row) {
    if constexpr (kHalf<CS>) {
      if (row >= CS) {
        *reinterpret_cast<float2*>(p.tgt + row * kF + f0) = make_float2(0.f, 0.f);
        *reinterpret_cast<uint32_t*>(p.xq + swz<kF>(row, f0)) = 0u;
        *reinterpret_cast<uint32_t*>(p.xk + swz<kF>(row, f0)) = 0u;
        if (p.t_hat != nullptr) {
          *reinterpret_cast<float2*>(p.t_hat + row * kF + f0) = make_float2(0.f, 0.f);
          if (lane == 0) p.s_t[row] = 1.f;
        }
        continue;
      }
    }
    const size_t xo = (((size_t)b * a.NC + n) * CS + row) * HF + (size_t)h * kF + f0;
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xq + xo));
    const float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xk + xo));
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xv + xo));
    const size_t to = ((size_t)n * CS + row) * kF + f0;
    const float2 c = *reinterpret_cast<const float2*>(a.cos + to);
    const float2 s = *reinterpret_cast<const float2*>(a.sin + to);
    // L2-norm: x / max(||x||, 1e-12); rope: x*cos + (x@R)*sin, (x@R) = (-x1, x0).
    const float dq = fmaxf(sqrtf(warp_sum(q.x * q.x + q.y * q.y)), 1e-12f);
    const float dk = fmaxf(sqrtf(warp_sum(k.x * k.x + k.y * k.y)), 1e-12f);
    const float qn0 = q.x / dq, qn1 = q.y / dq, kn0 = k.x / dk, kn1 = k.y / dk;
    const float XQ0 = qn0 * c.x + (-qn1) * s.x, XQ1 = qn1 * c.y + qn0 * s.y;
    const float XK0 = kn0 * c.x + (-kn1) * s.x, XK1 = kn1 * c.y + kn0 * s.y;
    // LN-reconstruction target: unbiased std, eps added to the std.
    const float t0 = v.x - XK0, t1 = v.y - XK1;
    const float mu = warp_sum(t0 + t1) * (1.f / kF);
    const float d0 = t0 - mu, d1 = t1 - mu;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) * ((float)kF / (kF - 1));
    const float sd = sqrtf(var) + 1e-8f;
    const float th0 = d0 / sd, th1 = d1 / sd;
    *reinterpret_cast<float2*>(p.tgt + row * kF + f0) = make_float2(lw.x * th0 + lb.x, lw.y * th1 + lb.y);
    *reinterpret_cast<uint32_t*>(p.xq + swz<kF>(row, f0)) = pack_bf16(XQ0, XQ1);
    *reinterpret_cast<uint32_t*>(p.xk + swz<kF>(row, f0)) = pack_bf16(XK0, XK1);
    if (p.t_hat != nullptr) {
      *reinterpret_cast<float2*>(p.t_hat + row * kF + f0) = make_float2(th0, th1);
      if (lane == 0) p.s_t[row] = sd;
    }
  }
  if (lane < kRows) {
    const int row = kRows * pw + lane;
    float sg = 0.f;
    if (!kHalf<CS> || row < CS) sg = 1.f / (1.f + expf(-a.gate[(((size_t)b * a.H + h) * a.NC + n) * CS + row]));
    p.eta[row] = sg * a.eta_scale;
    if (p.sig != nullptr) p.sig[row] = sg;
  }
}

// ---- the forward step
// The step's shared-memory tiles (padded bf16 unless noted).
struct Tiles {
  bf16 *x2c, *x2b;              // [CS][4F]: X2c = bf16(gelu(Z1)), X2_barc
  bf16* w2s;                    // [4F][F]: bf16(W2)
  float* z2;                    // [CS][kLdZ] fp32: Z2, then Z2_bar
  bf16 *gz2, *g2;               // [CS][F]: bf16(grad_z2), G2
  bf16* g1;                     // [CS][4F]: G1
  float* b1;                    // [4F] fp32: the state's b1
};

// Load the initial state (W1 [F][4F], b1 [4F], W2 [4F][F], b2 [F], fp32, of one head) into the registers and
// write the bf16 copy of W2.
__device__ __forceinline__ void load_state(State& st, const float* W1, const float* b1, const float* W2,
                                           const float* b2, bf16* w2s, float* b1s, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = 32 * warp + 16 * m + g + 8 * hr, c = 8 * f + 2 * t;
        st.w1[m][f][2 * hr] = W1[(size_t)c * kF4 + j];
        st.w1[m][f][2 * hr + 1] = W1[(size_t)(c + 1) * kF4 + j];
        const float2 v = *reinterpret_cast<const float2*>(W2 + (size_t)j * kF + c);
        st.w2[m][f][2 * hr] = v.x;
        st.w2[m][f][2 * hr + 1] = v.y;
      }
  if (g == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float2*>(b1s + 32 * warp + 8 * u + 2 * t) =
          *reinterpret_cast<const float2*>(b1 + 32 * warp + 8 * u + 2 * t);
  }
  __syncwarp();
  st.b2 = *reinterpret_cast<const float2*>(b2 + 2 * lane);
  store_state_rows(w2s, st.w2, warp, lane);
}

// Write the fp32 state as W1 [F][4F], b1 [4F], W2 [4F][F], b2 [F] (a checkpoint).
__device__ __forceinline__ void save_state(const State& st, const float* b1s, float* W1, float* b1, float* W2,
                                           float* b2, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = 32 * warp + 16 * m + g + 8 * hr, c = 8 * f + 2 * t;
        W1[(size_t)c * kF4 + j] = st.w1[m][f][2 * hr];
        W1[(size_t)(c + 1) * kF4 + j] = st.w1[m][f][2 * hr + 1];
        *reinterpret_cast<float2*>(W2 + (size_t)j * kF + c) = make_float2(st.w2[m][f][2 * hr], st.w2[m][f][2 * hr + 1]);
      }
  if (g == 0) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<float2*>(b1 + 32 * warp + 8 * u + 2 * t) = b1_pair(b1s, warp, u, lane);
  }
  if (warp == 0) *reinterpret_cast<float2*>(b2 + 2 * lane) = st.b2;
}

// Write the warp's rows of bf16(W1^T) and bf16(W2) as row-major [4F][F] (K2's pass-A stash).
__device__ __forceinline__ void stash_state(const State& st, bf16* W1t, bf16* W2, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int o = (32 * warp + 16 * m + g + 8 * hr) * kF + 8 * f + 2 * t;
        *reinterpret_cast<uint32_t*>(W1t + o) = pack_bf16(st.w1[m][f][2 * hr], st.w1[m][f][2 * hr + 1]);
        *reinterpret_cast<uint32_t*>(W2 + o) = pack_bf16(st.w2[m][f][2 * hr], st.w2[m][f][2 * hr + 1]);
      }
}

// grad_z2 = ln_fused_l2_bwd(Z2 + b2, target) for the warp's 2 NS rows (eps 1e-8 on the biased variance):
// bf16(grad_z2) into gz2, G2 = bf16(eta grad_z2) into g2.
template <int NS>
__device__ __forceinline__ void grad_z2_rows(const Tiles& T, const Prep& p, float2 b2, const float* ln_w,
                                             const float* ln_b, int warp, int lane) {
  constexpr int kR = 2 * NS;  // rows a warp
  const int f0 = 2 * lane;
  const float2 lw = *reinterpret_cast<const float2*>(ln_w + f0), lb = *reinterpret_cast<const float2*>(ln_b + f0);
#pragma unroll 2
  for (int r = kR * warp; r < kR * warp + kR; ++r) {
    const float2 z = *reinterpret_cast<const float2*>(T.z2 + r * kLdZ + f0);
    const float x0 = z.x + b2.x, x1 = z.y + b2.y;
    const float mu = warp_sum(x0 + x1) * (1.f / kF);
    const float d0 = x0 - mu, d1 = x1 - mu;
    const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
    const float xh0 = d0 / sd, xh1 = d1 / sd;
    const float2 tg = *reinterpret_cast<const float2*>(p.tgt + r * kF + f0);
    const float gx0 = (lw.x * xh0 + lb.x - tg.x) * lw.x;
    const float gx1 = (lw.y * xh1 + lb.y - tg.y) * lw.y;
    const float s1 = warp_sum(gx0 + gx1);
    const float s2 = warp_sum(gx0 * xh0 + gx1 * xh1);
    const float g0 = (1.f / kF) * (kF * gx0 - s1 - xh0 * s2) / sd;
    const float g1 = (1.f / kF) * (kF * gx1 - s1 - xh1 * s2) / sd;
    const float eta = p.eta[r];
    *reinterpret_cast<uint32_t*>(T.gz2 + swz<kF>(r, f0)) = pack_bf16(g0, g1);
    *reinterpret_cast<uint32_t*>(T.g2 + swz<kF>(r, f0)) = pack_bf16(eta * g0, eta * g1);
  }
}

// One dual-form step (ttt_forward.py:_mlp_kernel, l.298-322) on the state ``st``; ln_w/ln_b: the head's LN affine. With kOut it also writes
// out = XQ + LN(Z2_bar) for mini-batch n at ``out`` (token-major, head h; the CS real rows); without, it only
// advances the state.
template <int CS, bool kOut>
__device__ __forceinline__ void forward_step(State& st, const Prep& p, const Tiles& T, const float* ln_w,
                                             const float* ln_b, bf16* out, size_t out_row0, size_t out_stride,
                                             int warp, int lane) {
  constexpr int NS = slabs(CS), kR = 2 * NS;  // kR: rows a warp in the row passes
  const int g = lane >> 2, t = lane & 3, f0 = 2 * lane;
  const int r0 = 16 * (warp >> 1), c0 = 32 * (warp & 1);  // the warp's block of [CS][F] or [CS][CS] results
  const bool blk = owns_block<NS>(warp);

  // Z1 = XK @ bf16(W1) + b1; X2c = bf16(gelu(Z1)), slab by slab.
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    float z[4][4] = {};
    slab_by_state(z, p.xk, s, st.w1, lane);
    uint32_t x2[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 bb = b1_pair(T.b1, warp, u, lane);
      float y[4], unused;
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = tttb::gelu_and_grad(z[u][e] + ((e & 1) ? bb.y : bb.x), unused);
      x2[u][0] = pack_bf16(y[0], y[1]);
      x2[u][1] = pack_bf16(y[2], y[3]);
    }
    store_slab(T.x2c, x2, s, warp, lane);
    fence_state(st.w1);
  }
  fence_state(st.w1);
  hopper::named_sync(kConsumerBar, kConsumers);  // X2c written

  // Z2 = X2c @ bf16(W2) (b2 added by the row pass).
  if (blk) {
    float z2[4][4] = {};
    block_mm<kF4, kF4, kF, false>(z2, T.x2c, r0, T.w2s, c0, lane);
    store_block(T.z2, kLdZ, z2, r0, c0, lane);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // Z2 written
  grad_z2_rows<NS>(T, p, st.b2, ln_w, ln_b, warp, lane);
  hopper::named_sync(kConsumerBar, kConsumers);  // bf16(grad_z2), G2 written

  // G1 = bf16(eta * (bf16(grad_z2) @ bf16(W2)^T * gelu'(Z1))) on the warp's units, Z1 recomputed, into the warp's
  // columns of g1; b1 -= colsum(G1).
  {
    float cs[4][2] = {};
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      const float eta_lo = p.eta[16 * s + g], eta_hi = p.eta[16 * s + g + 8];
      uint32_t g1[4][2];
#pragma unroll
      for (int u0 = 0; u0 < 4; u0 += 2) {  // two n-tiles at a time: fewer live accumulators
        float gz[2][4] = {}, z[2][4] = {};
        slab_by_state<2>(gz, T.gz2, s, st.w2, lane, u0);
        slab_by_state<2>(z, p.xk, s, st.w1, lane, u0);
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) {
          const int u = u0 + uu;
          const float2 bb = b1_pair(T.b1, warp, u, lane);
          float gp[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tttb::gelu_and_grad(z[uu][e] + ((e & 1) ? bb.y : bb.x), gp[e]);
          g1[u][0] = pack_bf16(eta_lo * (gz[uu][0] * gp[0]), eta_lo * (gz[uu][1] * gp[1]));
          g1[u][1] = pack_bf16(eta_hi * (gz[uu][2] * gp[2]), eta_hi * (gz[uu][3] * gp[3]));
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][0]));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][1]));
          cs[u][0] += lo.x + hi.x;
          cs[u][1] += lo.y + hi.y;
        }
      }
      store_slab(T.g1, g1, s, warp, lane);
      fence_state(st.w1);
      fence_state(st.w2);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // lanes (g, t) hold units 8u + 2t, + 1 summed over their rows; sum over g
      float c0s = cs[u][0], c1s = cs[u][1];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        c0s += __shfl_xor_sync(0xffffffffu, c0s, off);
        c1s += __shfl_xor_sync(0xffffffffu, c1s, off);
      }
      if (g == 0) {
        float2* bb = reinterpret_cast<float2*>(T.b1 + 32 * warp + 8 * u + 2 * t);
        *bb = make_float2(bb->x - c0s, bb->y - c1s);
      }
    }
    __syncwarp();  // the warp's b1 and columns of G1 are written
  }

  if (kOut) {  // Z1_bar = XQ @ bf16(W1) - attn1 @ G1 + b1 (the new b1); X2_barc = bf16(gelu(Z1_bar)).
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      float zb[4][4] = {};
      slab_by_state(zb, p.xq, s, st.w1, lane);
      unit_mm_xyt<kF, NS>(zb, p.xq, p.xk, s, true, T.g1, warp, lane);
      uint32_t xb[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 bb = b1_pair(T.b1, warp, u, lane);
        float y[4], unused;
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = tttb::gelu_and_grad(zb[u][e] + ((e & 1) ? bb.y : bb.x), unused);
        xb[u][0] = pack_bf16(y[0], y[1]);
        xb[u][1] = pack_bf16(y[2], y[3]);
      }
      store_slab(T.x2b, xb, s, warp, lane);
      fence_state(st.w1);
    }
  }
  // W1^T -= G1^T @ XK.
  rows_update<NS, true>(st.w1, T.g1, p.xk, warp, lane);

  if (kOut) {
    hopper::named_sync(kConsumerBar, kConsumers);  // X2_barc written
    // Z2_bar without b2 = X2_barc @ bf16(W2) - bf16(X2_barc @ X2c^T) @ G2.
    if (blk) {
      float zb2[4][4] = {};
      block_mm<kF4, kF4, kF, false>(zb2, T.x2b, r0, T.w2s, c0, lane);
      block_mm_xyt<kF4, NS>(zb2, T.x2b, T.x2c, r0 / 16, true, T.g2, c0, lane);
      store_block(T.z2, kLdZ, zb2, r0, c0, lane);
    }
    hopper::named_sync(kConsumerBar, kConsumers);  // Z2_bar written; nobody reads bf16(W2) any more this step
  }

  // W2 -= X2c^T @ G2 (the warp's rows), then refresh its rows of bf16(W2); b2 -= colsum(G2).
  rows_update<NS, true>(st.w2, T.x2c, T.g2, warp, lane);
  store_state_rows(T.w2s, st.w2, warp, lane);
  {
    float2 cs = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < kSlab * NS; ++r) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(T.g2 + swz<kF>(r, f0)));
      cs.x += v.x;
      cs.y += v.y;
    }
    st.b2.x -= cs.x;
    st.b2.y -= cs.y;
  }

  if (kOut) {  // the warp's rows: out = XQ + LN(Z2_bar + b2) (eps 1e-8 on the biased variance)
    const float2 lw = *reinterpret_cast<const float2*>(ln_w + f0), lb = *reinterpret_cast<const float2*>(ln_b + f0);
#pragma unroll 2
    for (int r = kR * warp; r < kR * warp + kR; ++r) {
      if constexpr (kHalf<CS>) {
        if (r >= CS) break;  // the padding (warps 4-7 in a half slab)
      }
      const float2 z = *reinterpret_cast<const float2*>(T.z2 + r * kLdZ + f0);
      const float x0 = z.x + st.b2.x, x1 = z.y + st.b2.y;
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.xq + swz<kF>(r, f0)));
      *reinterpret_cast<__nv_bfloat162*>(out + out_row0 + r * out_stride + f0) =
          __floats2bfloat162_rn(q.x + (lw.x * (d0 / sd) + lb.x), q.y + (lw.y * (d1 / sd) + lb.y));
    }
  }
}

}  // namespace ttts
