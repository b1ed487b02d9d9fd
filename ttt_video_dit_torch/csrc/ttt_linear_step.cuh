// The TTT-linear step at head_dim F = 64 and mini-batch CS = 8, 16, ..., 64
// (NS = ceil(CS / 16) slabs of 16 tokens, ttt_mlp_block.cuh:slabs), on the
// tensor cores, for Hopper (sm_90a). Shared by K5 (ttt_linear_forward.cu: sampling with the output,
// training with fp32 state checkpoints) and K6's pass A
// (ttt_linear_backward.cu: no output, each step's operands stashed for pass
// B), with the producer that prepares each mini-batch and the fragment
// loaders K6's pass B uses. Every piece that reads or writes device memory is
// a template on CS, the tiles on NS; ttt_mlp_block.cuh:with_slabs
// instantiates the eight values, and ops/ttt_linear_kernel.py's
// KERNEL_MINI_BATCHES names the same list (a test holds the two together).
//
// One block owns one (batch, head) scan: 4 consumer warps run the step, a
// producer warpgroup (4 warps) prepares the next mini-batch.
//
// - The fp32 state W [F][F] lives in the consumers' registers as W^T in the
//   mma.sync m16n8k16 accumulator layout: warp w owns rows c = 16 w ..
//   16 w + 15 of W^T (the output columns c of XK W), 32 registers a thread
//   (LinState), whatever CS is. Packed to bf16 pairs (cvt.rn.bf16x2,
//   W.astype(dt)) they are the B fragments of Z1 = XK W + b and XQ W, so each
//   warp computes its own 16-column blocks of every slab with no cross-warp
//   sum; the update W^T -= Gs^T XK accumulates into the same registers, slab
//   after slab, after Z1_bar has used the old W.
// - Each 16-token slab is one m16 tile. attn = bf16(XQ XK^T) is NS x NS
//   blocks of 16 x 16 (over k = 64), all of them: the dual form of
//   _linear_kernel uses the whole matrix (eta is per token, not a causal
//   mask). The producer warps compute them on the tensor cores (block i by
//   warp i % 4) and hand them over, negated, as the A fragments of Z1_bar's
//   attn @ Gs.
// - The row-wise phases (the fused LN-L2 gradient and the output LN) need
//   whole 64-wide rows: Z1 and Z1_bar go through padded fp32 [CS][68] tiles,
//   Gs through a padded bf16 [CS][72] one (ldmatrix of 8 rows at one column
//   hits 8 banks), with named barriers among the 128 consumer threads: three
//   a step with the output, two without. In a row phase warp w takes rows
//   16 s + 4 w .. 16 s + 4 w + 3 of every slab s (CS / 4 rows), 8 lanes a row
//   and 8 features a lane, so a row's sums are 3 shuffles and the warp's four
//   rows of a slab go at once.
// - Operands are rounded to bf16 exactly where _linear_kernel calls
//   .astype(dt): XQ and XK after preprocessing, W for Z1 and XQ W, Gs, attn.
//   Only the fp32 summation order differs from the plain version.
// - The producer warpgroup cp.asyncs the raw q/k/v, gate and rope rows of the
//   mini-batch after next into a raw ring (each warp its own CS / 4 rows), and
//   prepares the next one (L2-norm, rope, target LN, eta; then attn) into a
//   two-stage ring signalled by full/empty mbarriers, so the preprocessing is
//   off the step's critical path. (K1's producer, ttt_mlp_forward.cu, does the
//   same work under setmaxnreg's 40-register cap: 2 features a lane, one row
//   at a time. This one has the whole register file: 8 features a lane, a
//   warp's four rows at once, and K6's stash writes.)
// - Shared memory grows with CS: a raw stage is 14 KiB x NS (bf16 q/k/v and
//   fp32 rope rows), a prepared one 8.6 KiB x NS + 0.5 KiB x NS^2, the step's
//   tiles 10.8 KiB x NS. At CS 64 two raw stages do not fit beside the rest
//   (K5: 240 KiB of the 227 KiB a block may have), so the raw ring has one
//   stage there (kRawSlots): the producer issues the next mini-batch's loads
//   as soon as it has read this one's rows, and waits for them before it
//   prepares it; it still runs up to two prepared stages ahead of the
//   consumers, whose step is then four times as long. K6's layout is in
//   ttt_linear_backward.cu.
// - A half slab (CS 8, 24, 40, 56): the tiles keep 16 NS rows, device
//   memory is addressed with CS. The producer loads only the CS real rows and
//   prepares the padding as XQ = XK = 0, target 0 and eta 0, so the padding's
//   Gs rows are 0 and it adds nothing to b, to W or to attn @ Gs; no padded
//   row is stored. At a multiple of 16 the masking is not compiled.
// - 8 warps leave each thread up to 255 registers: no setmaxnreg.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"

namespace tttl {

using bf16 = __nv_bfloat16;
using hopper::mma_bf16_16816;
using hopper::movmatrix_trans;
using hopper::pack_bf16;
using tttb::ScanArgs;
using tttb::slabs;
using tttb::with_slabs;

constexpr int kF = 64;
constexpr int kSlab = 16;                   // tokens of one m16 tile
constexpr int kWarps = 4;                   // consumer warps
constexpr int kConsumers = 32 * kWarps;     // consumer threads
constexpr int kThreads = 2 * kConsumers;    // + the producer warpgroup
constexpr int kLdB = kF + 8;                // row pitch of the bf16 tiles (144 bytes)
constexpr int kLdZ = kF + 4;                // row pitch of the fp32 tiles
constexpr int kConsumerBar = 1;             // named barrier of the consumer warps
constexpr int kProducerBar = 2;             // named barrier of the producer warpgroup
constexpr uint32_t kSignBits = 0x80008000u;

// Whether a mini-batch of CS tokens ends in a half slab (tile rows CS .. 16 NS - 1 are padding).
template <int CS>
constexpr bool kHalf = CS % kSlab != 0;

// Stages of the producer's raw ring: two, but one at CS 64 (see the top).
template <int NS>
constexpr int kRawSlots = NS <= 3 ? 2 : 1;

template <int NS>
struct RawStage {  // one mini-batch as loaded, for one (batch, head)
  static constexpr int kCS = kSlab * NS;
  bf16 q[kCS * kF], k[kCS * kF], v[kCS * kF];
  float cos[kCS * kF], sin[kCS * kF];
  float gate[kCS];
};

template <int NS>
struct RawStageB : RawStage<NS> {  // K6's pass B: the output cotangent rows too
  bf16 dout[kSlab * NS * kF];
};

template <int NS>
struct PrepStage {  // one mini-batch as the step takes it
  static constexpr int kCS = kSlab * NS;
  bf16 xq[kCS * kLdB], xk[kCS * kLdB];  // bf16(XQ), bf16(XK)
  float tgt[kCS * kF];                  // LN-reconstruction target
  float eta[kCS];
  uint32_t neg_attn[NS * NS * 128];     // -bf16(XQ XK^T): block (s, j) (rows 16 s.., columns 16 j..) as an mma
                                        // A fragment, lane-major, at 128 (NS s + j)
};

// One pass-A step of K6 as its pass B reads it back: the bf16 part and the
// fp32 part (two workspaces), each a byte image of the tiles above.
template <int NS>
struct StashH {
  static constexpr int kCS = kSlab * NS;
  bf16 wt[kF * kLdB];                               // bf16(W^T) [c][k] before the step
  bf16 xq[kCS * kLdB], xk[kCS * kLdB], gs[kCS * kLdB];
  uint32_t neg_attn[NS * NS * 128];
};
template <int NS>
struct StashF {
  static constexpr int kCS = kSlab * NS;
  float z1[kCS * kLdZ], zb1[kCS * kLdZ];            // Z1 and Z1_bar (b included)
};

template <int NS>
constexpr bool aligned_stages() {
  return sizeof(RawStage<NS>) % 16 == 0 && sizeof(RawStageB<NS>) % 16 == 0 && sizeof(PrepStage<NS>) % 16 == 0 &&
         sizeof(StashH<NS>) % 16 == 0 && sizeof(StashF<NS>) % 16 == 0;
}
static_assert(aligned_stages<1>() && aligned_stages<2>() && aligned_stages<3>() && aligned_stages<4>(),
              "16-byte aligned stages and stash images");

template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {  // sum over kLanes neighbouring lanes
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__device__ __forceinline__ void ld_bf16(float (&x)[N], const bf16* p) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i / 2]);
    x[i] = v.x;
    x[i + 1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void ld_f32(float (&x)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = reinterpret_cast<const float4*>(p)[i / 4];
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void st_f32(float* p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) reinterpret_cast<float4*>(p)[i / 4] = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
}

// N values rounded to bf16 (N = 4: 8 bytes, N = 8: 16 bytes).
template <int N>
__device__ __forceinline__ void st_bf16(bf16* p, const float (&x)[N]) {
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  } else {
    static_assert(N == 4, "4 or 8 values");
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// ---- fragment loaders (row pitch kLdB)
// A fragment of the 16 x 16 block at rows r0.., columns k0.. of a row-major tile.
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int r0, int k0, int lane) {
  hopper::ldsm_x4(a, hopper::ldsm_row(t + r0 * kLdB, kLdB, k0, lane));
}

// B fragments (b[0], b[1]: n-tile n0; b[2], b[3]: n-tile n0 + 8) of k-tile k0.. from a [k][n] row-major tile.
// Reordered {b[0], b[2], b[1], b[3]} they are the A fragment of the 16 x 16 block (rows n0.., columns k0..)
// of the tile's transpose.
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0, int lane) {
  hopper::ldsm_x4_trans(b, hopper::ldsm_row(t + k0 * kLdB, kLdB, n0, lane));
}

// The same from an [n][k] row-major tile (B = the tile transposed).
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t, int n0, int k0, int lane) {
  hopper::ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdB + k0 + ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void negate(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] ^= kSignBits;
}

// The A fragment of the transpose of the 16 x 16 matrix whose A fragment is ``a``.
__device__ __forceinline__ void transpose_a(uint32_t (&at)[4], const uint32_t (&a)[4]) {
  at[0] = movmatrix_trans(a[0]);
  at[1] = movmatrix_trans(a[2]);
  at[2] = movmatrix_trans(a[1]);
  at[3] = movmatrix_trans(a[3]);
}

// A fragment ``i`` of a lane-major array of them (the -attn blocks).
__device__ __forceinline__ void ld_frag(uint32_t (&a)[4], const uint32_t* frags, int i, int lane) {
  const uint4 v = *reinterpret_cast<const uint4*>(frags + i * 128 + lane * 4);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// Store a warp's 16 x 16 fp32 block (n-tiles u = 0, 1 at columns c0 + 8 u) into the 16 rows at ``dst`` of an
// fp32 tile.
__device__ __forceinline__ void store_block(float* dst, const float (&acc)[2][4], int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    *reinterpret_cast<float2*>(dst + g * kLdZ + c0 + 8 * u + 2 * t) = make_float2(acc[u][0], acc[u][1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * kLdZ + c0 + 8 * u + 2 * t) = make_float2(acc[u][2], acc[u][3]);
  }
}

// The sum over the CS = 16 NS rows of columns c0 + 8 u + 2t, + 1 of an fp32 tile, in every lane.
template <int NS>
__device__ __forceinline__ float2 column_sum(const float* src, int c0, int u, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(src + (kSlab * j + g) * kLdZ + c0 + 8 * u + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(src + (kSlab * j + g + 8) * kLdZ + c0 + 8 * u + 2 * t);
    x += a.x + b.x;
    y += a.y + b.y;
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
  return make_float2(x, y);
}

// ---- the producer
// cp.async rows row0 .. row0 + rows - 1 of mini-batch n (q/k/v, the rope rows, gate; with ``dout``, its rows into
// ``dout_dst``) into ``r``, chunks of 16 bytes spread over ``nthreads`` threads (this one is ``tid``); the caller
// commits. Rows past the CS real ones (a half slab's padding) are not loaded. row0, rows and CS are multiples of 4.
template <int CS>
__device__ __forceinline__ void load_rows(RawStage<slabs(CS)>& r, bf16* dout_dst, const ScanArgs& a,
                                          const bf16* dout, int b, int h, int n, int row0, int rows, int tid,
                                          int nthreads) {
  if constexpr (kHalf<CS>) rows = min(rows, CS - row0);
  const size_t HF = (size_t)a.H * kF;
  const size_t x0 = ((size_t)b * a.NC + n) * CS * HF + (size_t)h * kF;
  for (int i = tid; i < rows * 8; i += nthreads) {
    const int row = row0 + (i >> 3), c = (i & 7) * 8;
    const size_t go = x0 + row * HF + c;
    const int so = row * kF + c;
    hopper::cp_async16(r.q + so, a.xq + go);
    hopper::cp_async16(r.k + so, a.xk + go);
    hopper::cp_async16(r.v + so, a.xv + go);
    if (dout != nullptr) hopper::cp_async16(dout_dst + so, dout + go);
  }
  const size_t t0 = ((size_t)n * CS + row0) * kF;
  for (int i = tid; i < rows * kF / 4; i += nthreads) {
    hopper::cp_async16(r.cos + row0 * kF + 4 * i, a.cos + t0 + 4 * i);
    hopper::cp_async16(r.sin + row0 * kF + 4 * i, a.sin + t0 + 4 * i);
  }
  const size_t g0 = (((size_t)b * a.H + h) * a.NC + n) * CS + row0;
  for (int i = tid; i < rows / 4; i += nthreads) hopper::cp_async16(r.gate + row0 + 4 * i, a.gate + g0 + 4 * i);
}

// L2-norm and rope of N features (pairs interleaved) of one row: x / max(||x||, 1e-12), then
// x*cos + (x@R)*sin with (x@R) = (-x1, x0); the norm is summed over kLanes lanes.
template <int kLanes, int N>
__device__ __forceinline__ void l2norm_rope(float (&y)[N], const float (&x)[N], const float (&c)[N],
                                            const float (&s)[N]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) ss += x[i] * x[i];
  const float d = fmaxf(sqrtf(group_sum<kLanes>(ss)), 1e-12f);
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float x0 = x[i] / d, x1 = x[i + 1] / d;
    y[i] = x0 * c[i] + (-x1) * s[i];
    y[i + 1] = x1 * c[i + 1] + x0 * s[i + 1];
  }
}

// The LN-reconstruction target from t = v - XK (unbiased std, eps added to the std): t_hat = (t - mu) / sd,
// returns sd; the sums over kLanes lanes.
template <int kLanes, int N>
__device__ __forceinline__ float target_ln(float (&that)[N], const float (&t)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += t[i];
  const float mu = group_sum<kLanes>(s) * (1.f / kF);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) v += (t[i] - mu) * (t[i] - mu);
  const float sd = sqrtf(group_sum<kLanes>(v) * (1.f / kF) * ((float)kF / (kF - 1))) + 1e-8f;
#pragma unroll
  for (int i = 0; i < N; ++i) that[i] = (t[i] - mu) / sd;
  return sd;
}

// (x - mu) / std with std = sqrt(biased var + 1e-8) over a 64-wide row held by kLanes lanes; returns std.
template <int kLanes, int N>
__device__ __forceinline__ float ln_stats(float (&xh)[N], const float (&x)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += x[i];
  const float mu = group_sum<kLanes>(s) * (1.f / kF);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) v += (x[i] - mu) * (x[i] - mu);
  const float sd = sqrtf(group_sum<kLanes>(v) * (1.f / kF) + 1e-8f);
#pragma unroll
  for (int i = 0; i < N; ++i) xh[i] = (x[i] - mu) / sd;
  return sd;
}

// L2-norm, rope, target LN and eta of producer warp pw's rows 4 NS pw .. 4 NS pw + 4 NS - 1, four at a time:
// lane = row 4 NS pw + 4 i + lane / 8, features 8 (lane % 8) .. + 7. With ``stash``, the rows' bf16 XQ and XK
// also go there. A half slab's padding (four rows at a time, as CS is a multiple of 8) gets XQ = XK = 0, target 0
// and eta 0.
template <int CS>
__device__ __forceinline__ void prepare_rows(PrepStage<slabs(CS)>& p, const RawStage<slabs(CS)>& r, float eta_scale,
                                             const float (&lw)[8], const float (&lb)[8], int pw, int lane,
                                             StashH<slabs(CS)>* stash) {
  constexpr int NS = slabs(CS);
  const int f = 8 * (lane & 7);
#pragma unroll 1
  for (int i = 0; i < NS; ++i) {
    const int row = 4 * NS * pw + 4 * i + (lane >> 3);
    float q[8], k[8], v[8], c[8], s[8], xq[8], xk[8], t[8], th[8];
    if constexpr (kHalf<CS>) {
      if (row >= CS) {
        const float zero[8] = {};
        st_f32(p.tgt + row * kF + f, zero);
        st_bf16(p.xq + row * kLdB + f, zero);
        st_bf16(p.xk + row * kLdB + f, zero);
        if (stash != nullptr) {
          st_bf16(stash->xq + row * kLdB + f, zero);
          st_bf16(stash->xk + row * kLdB + f, zero);
        }
        if ((lane & 7) == 0) p.eta[row] = 0.f;
        continue;
      }
    }
    ld_bf16(q, r.q + row * kF + f);
    ld_bf16(k, r.k + row * kF + f);
    ld_bf16(v, r.v + row * kF + f);
    ld_f32(c, r.cos + row * kF + f);
    ld_f32(s, r.sin + row * kF + f);
    l2norm_rope<8>(xq, q, c, s);
    l2norm_rope<8>(xk, k, c, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = v[j] - xk[j];
    target_ln<8>(th, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = lw[j] * th[j] + lb[j];
    st_f32(p.tgt + row * kF + f, t);
    st_bf16(p.xq + row * kLdB + f, xq);
    st_bf16(p.xk + row * kLdB + f, xk);
    if (stash != nullptr) {
      st_bf16(stash->xq + row * kLdB + f, xq);
      st_bf16(stash->xk + row * kLdB + f, xk);
    }
    if ((lane & 7) == 0) p.eta[row] = (1.f / (1.f + expf(-r.gate[row]))) * eta_scale;
  }
}

// attn = bf16(XQ XK^T) on the tensor cores, block (s, j) = i by producer warp i % 4, stored negated as the A
// fragment of the step's attn @ Gs (and, with ``stash``, there too).
template <int NS>
__device__ __forceinline__ void prepare_attn(PrepStage<NS>& p, int pw, int lane, uint32_t* stash) {
#pragma unroll 1
  for (int i = pw; i < NS * NS; i += 4) {
    const int s = i / NS, j = i % NS;
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kF / 16; ++kk) {
      uint32_t qa[4], kb[4];
      lda(qa, p.xq, kSlab * s, kk * 16, lane);
      ldb_nk(kb, p.xk, kSlab * j, kk * 16, lane);
      mma_bf16_16816(acc[0], qa, kb[0], kb[1]);
      mma_bf16_16816(acc[1], qa, kb[2], kb[3]);
    }
    const uint4 na = make_uint4(pack_bf16(acc[0][0], acc[0][1]) ^ kSignBits, pack_bf16(acc[0][2], acc[0][3]) ^ kSignBits,
                                pack_bf16(acc[1][0], acc[1][1]) ^ kSignBits, pack_bf16(acc[1][2], acc[1][3]) ^ kSignBits);
    *reinterpret_cast<uint4*>(p.neg_attn + i * 128 + lane * 4) = na;
    if (stash != nullptr) *reinterpret_cast<uint4*>(stash + i * 128 + lane * 4) = na;
  }
}

// Producer warp pw (of 4) prepares mini-batches n0 .. n0 + count - 1 into the ring; ``it0`` is the number of
// mini-batches the ring has carried before (its stages and mbarrier phases continue from there). With
// ``stash`` (K6's pass A), each prepared XQ, XK and -attn also goes to stash[i].
template <int CS>
__device__ void producer(RawStage<slabs(CS)>* raw, PrepStage<slabs(CS)>* prep, uint64_t* full, uint64_t* empty,
                         const ScanArgs& a, const float* ln_w, const float* ln_b, int b, int h, int n0, int count,
                         int it0, int pw, int lane, StashH<slabs(CS)>* stash) {
  constexpr int NS = slabs(CS), R = kRawSlots<NS>, kRows = 4 * NS;
  const int f = 8 * (lane & 7);
  float lw[8], lb[8];
  ld_f32(lw, ln_w + (size_t)h * kF + f);
  ld_f32(lb, ln_b + (size_t)h * kF + f);
  load_rows<CS>(raw[it0 % R], nullptr, a, nullptr, b, h, n0, kRows * pw, kRows, lane, 32);
  hopper::cp_async_commit();
  for (int i = 0; i < count; ++i) {
    const int it = it0 + i, s = it & 1, rs = it % R;
    __syncwarp();  // every lane is done with the raw stage it refills
    if (R == 2 && i + 1 < count) {
      load_rows<CS>(raw[rs ^ 1], nullptr, a, nullptr, b, h, n0 + i + 1, kRows * pw, kRows, lane, 32);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncwarp();  // this warp's rows of raw[rs] have landed
    if (it >= 2) hopper::mbar_wait(&empty[s], ((it >> 1) - 1) & 1);
    prepare_rows<CS>(prep[s], raw[rs], a.eta_scale, lw, lb, pw, lane, stash != nullptr ? stash + i : nullptr);
    if (R == 1 && i + 1 < count) {  // one raw stage: refill it now that this warp has read its rows
      __syncwarp();
      load_rows<CS>(raw[0], nullptr, a, nullptr, b, h, n0 + i + 1, kRows * pw, kRows, lane, 32);
      hopper::cp_async_commit();
    }
    hopper::named_sync(kProducerBar, 128);
    prepare_attn<NS>(prep[s], pw, lane, stash != nullptr ? stash[i].neg_attn : nullptr);
    hopper::mbar_arrive(&full[s]);
  }
}

// ---- the consumers
// Warp w, lane = 4 g + t. w[f][..]: W^T rows c = 16 w + g (elements 0, 1) and 16 w + g + 8 (2, 3), columns
// k = 8 f + 2t, 8 f + 2t + 1. bias[u]: b of columns 16 w + 8 u + 2t, + 1 (the same in the 8 lanes of a t).
// Per-token products over the warp's columns (16 tokens of a slab x 16 columns, n-tile u): rows g (0, 1) and
// g + 8 (2, 3), columns 16 w + 8 u + 2t, + 1.
struct LinState {
  float w[8][4];
  float2 bias[2];
};

// The B fragment (k-tile kk, n-tile u) of X @ bf16(W): pairs of W^T row 16 w + 8 u + g.
__device__ __forceinline__ uint32_t state_b(const float (&w)[8][4], int u, int f) {
  return pack_bf16(w[f][2 * u], w[f][2 * u + 1]);
}

// Load the state from W [F][F] (W[k][c]) and b [F] fp32; save it back (also K6's dW^T carry as dW).
__device__ __forceinline__ void load_state(LinState& st, const float* W, const float* b, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * warp + g + 8 * hr, k = 8 * f + 2 * t;
      st.w[f][2 * hr] = W[k * kF + c];
      st.w[f][2 * hr + 1] = W[(k + 1) * kF + c];
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) st.bias[u] = *reinterpret_cast<const float2*>(b + 16 * warp + 8 * u + 2 * t);
}

__device__ __forceinline__ void save_state(const float (&w)[8][4], const float2 (&bias)[2], float* W, float* b,
                                           int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * warp + g + 8 * hr, k = 8 * f + 2 * t;
      W[k * kF + c] = w[f][2 * hr];
      W[(k + 1) * kF + c] = w[f][2 * hr + 1];
    }
  if (g == 0)
#pragma unroll
    for (int u = 0; u < 2; ++u) *reinterpret_cast<float2*>(b + 16 * warp + 8 * u + 2 * t) = bias[u];
}

// bf16(W^T) rows of the warp into a [F][kLdB] tile (K6: the stash, and the carry's copy).
__device__ __forceinline__ void store_wt(bf16* dst, const float (&w)[8][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(dst + (16 * warp + g + 8 * hr) * kLdB + 8 * f + 2 * t) =
          pack_bf16(w[f][2 * hr], w[f][2 * hr + 1]);
}

// w[f] += A @ Y[0..15, 8 f ..]: A a 16 (rows of W^T) x 16 (tokens) fragment, Y the 16 rows of one slab of a
// token-major [CS][kLdB] tile.
__device__ __forceinline__ void update_rows(float (&w)[8][4], const uint32_t (&a)[4], const bf16* Y, int lane) {
#pragma unroll
  for (int fp = 0; fp < kF / 16; ++fp) {
    uint32_t yb[4];
    ldb_kn(yb, Y, 0, 16 * fp, lane);
    mma_bf16_16816(w[2 * fp], a, yb[0], yb[1]);
    mma_bf16_16816(w[2 * fp + 1], a, yb[2], yb[3]);
  }
}

struct StepTiles {
  float* z;   // [CS][kLdZ] Z1
  bf16* gs;   // [CS][kLdB] Gs
  float* zb;  // [CS][kLdZ] Z1_bar (with the output only)
};

// One mini-batch step of the consumer warps on the prepared stage ``p``. kOut: out = XQ + LN(Z1_bar) into the
// token-major rows at ``out`` (row stride HF; the CS real rows). kStash: bf16(W^T), Gs, Z1 and Z1_bar of the step
// into sh / sf.
template <int CS, bool kOut, bool kStash>
__device__ __forceinline__ void step(LinState& st, const PrepStage<slabs(CS)>& p, const StepTiles& T,
                                     const float (&lw)[8], const float (&lb)[8], bf16* out, size_t HF,
                                     StashH<slabs(CS)>* sh, StashF<slabs(CS)>* sf, int warp, int lane) {
  constexpr int NS = slabs(CS);
  const int c0 = 16 * warp;
  if (kStash) store_wt(sh->wt, st.w, warp, lane);

  // Z1 = XK @ bf16(W) + b and XQ @ bf16(W), the warp's 16 columns of every slab.
  float z[NS][2][4] = {}, q[NS][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kF / 16; ++kk) {
    uint32_t b0[2], b1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      b0[u] = state_b(st.w, u, 2 * kk);
      b1[u] = state_b(st.w, u, 2 * kk + 1);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      uint32_t ak[4], aq[4];
      lda(ak, p.xk, kSlab * s, 16 * kk, lane);
      lda(aq, p.xq, kSlab * s, 16 * kk, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        mma_bf16_16816(z[s][u], ak, b0[u], b1[u]);
        mma_bf16_16816(q[s][u], aq, b0[u], b1[u]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[s][u][e] += (e & 1) ? st.bias[u].y : st.bias[u].x;
    store_block(T.z + kSlab * s * kLdZ, z[s], c0, lane);
    if (kStash) store_block(sf->z1 + kSlab * s * kLdZ, z[s], c0, lane);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (1) Z1's rows

  // Gs = bf16(eta * ln_fused_l2_bwd(Z1, target)), eps 1e-8 on the biased variance, in the forward's form
  // (1/F) (F gx - sum gx - xh sum(gx xh)) / sd. Rows 16 s + 4 warp + lane / 8, features 8 (lane % 8) ...
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int row = kSlab * s + 4 * warp + (lane >> 3), f = 8 * (lane & 7);
    float x[8], xh[8], tg[8], gx[8];
    ld_f32(x, T.z + row * kLdZ + f);
    ld_f32(tg, p.tgt + row * kF + f);
    const float sd = ln_stats<8>(xh, x);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gx[i] = (lw[i] * xh[i] + lb[i] - tg[i]) * lw[i];
      s1 += gx[i];
      s2 += gx[i] * xh[i];
    }
    s1 = group_sum<8>(s1);
    s2 = group_sum<8>(s2);
    const float eta = p.eta[row];
#pragma unroll
    for (int i = 0; i < 8; ++i) gx[i] = eta * ((1.f / kF) * (kF * gx[i] - s1 - xh[i] * s2) / sd);
    st_bf16(T.gs + row * kLdB + f, gx);
    if (kStash) st_bf16(sh->gs + row * kLdB + f, gx);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (2) Gs

  // b -= colsum(Gs); Z1_bar = XQ @ bf16(W) - attn @ Gs + b; W^T -= Gs^T @ XK.
  uint32_t gb[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) ldb_kn(gb[j], T.gs, kSlab * j, c0, lane);  // B fragments of Gs's columns c0.., slab j
  {
    const int g = lane >> 2, t = lane & 3;
    float cs[2][2] = {};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int r0 = kSlab * j + g, r1 = r0 + 8;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(T.gs + r0 * kLdB + c0 + 8 * u + 2 * t));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(T.gs + r1 * kLdB + c0 + 8 * u + 2 * t));
        cs[u][0] += a.x + b.x;
        cs[u][1] += a.y + b.y;
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        cs[u][0] += __shfl_xor_sync(0xffffffffu, cs[u][0], off);
        cs[u][1] += __shfl_xor_sync(0xffffffffu, cs[u][1], off);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      st.bias[u].x -= cs[u][0];
      st.bias[u].y -= cs[u][1];
    }
  }
  if (kOut || kStash) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t na[4];
        ld_frag(na, p.neg_attn, NS * s + j, lane);
        mma_bf16_16816(q[s][0], na, gb[j][0], gb[j][1]);
        mma_bf16_16816(q[s][1], na, gb[j][2], gb[j][3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[s][u][e] += (e & 1) ? st.bias[u].y : st.bias[u].x;
      if (kOut) store_block(T.zb + kSlab * s * kLdZ, q[s], c0, lane);
      if (kStash) store_block(sf->zb1 + kSlab * s * kLdZ, q[s], c0, lane);
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    uint32_t a[4] = {gb[j][0], gb[j][2], gb[j][1], gb[j][3]};  // Gs^T rows c0.., tokens of slab j (A), negated
    negate(a);
    update_rows(st.w, a, p.xk + kSlab * j * kLdB, lane);
  }
  if (kOut) {
    hopper::named_sync(kConsumerBar, kConsumers);  // (3) Z1_bar's rows
    // out = XQ + LN(Z1_bar), eps 1e-8 on the biased variance.
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      const int row = kSlab * s + 4 * warp + (lane >> 3), f = 8 * (lane & 7);
      if constexpr (kHalf<CS>) {
        if (row >= CS) continue;  // warps 2-3 in a half slab: padding only
      }
      float x[8], xh[8], xq[8];
      ld_f32(x, T.zb + row * kLdZ + f);
      ld_bf16(xq, p.xq + row * kLdB + f);
      ln_stats<8>(xh, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = xq[i] + (lw[i] * xh[i] + lb[i]);
      st_bf16(out + row * HF + f, x);
    }
  }
}

}  // namespace tttl
