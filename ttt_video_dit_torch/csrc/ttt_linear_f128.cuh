// The TTT-linear step at head_dim F = 128, mini-batch CS = 16, on the tensor
// cores, for Hopper (sm_90a). Shared by K5@F128 (ttt_linear_forward_f128.cu:
// sampling with the output, training with fp32 state checkpoints) and K6@F128's
// pass A (ttt_linear_backward_f128.cu: no output, each step's operands stashed
// for pass B), with the producer that prepares each mini-batch and the row
// and fragment helpers K6@F128's pass B uses. ttt_linear_step.cuh's design,
// widened to 128 (a header of its own, so that no head-dim-64 kernel changes).
//
// One block of 12 warps owns one (batch, head) scan:
// - 8 consumer warps keep the fp32 state W^T (128 x 128, 64 KiB) in mma.sync
//   m16n8k16 accumulator registers: warp w owns rows c = 16 w .. 16 w + 15 of
//   W^T (the output columns c of XK W), 64 registers a thread. Packed to bf16
//   pairs they are the B fragments of Z1 = XK W + b and XQ W, so each warp
//   computes its own 16-column block of every product with no cross-warp
//   sum; the update W^T -= Gs^T XK accumulates into the same registers after
//   Z1_bar has used the old W. The consumers meet at named barriers (id 1,
//   256 threads): three a step with the output, two without.
// - The row phases (the fused LN-L2 gradient and the output LN) need whole
//   128-wide rows: Z1 and Z1_bar go through padded fp32 [CS][132] tiles, Gs
//   through a padded bf16 [CS][136] one (a row pitch 16 bytes past a multiple
//   of 128, so ldmatrix's 8 rows at one column hit 8 bank groups). In a row
//   phase 16 lanes take a row, 8 features a lane, so each warp takes two rows
//   of a 16-token slab and the 8 warps the slab's 16 rows.
// - 4 producer warps (named barrier 2) cp.async the raw q/k/v, gate and rope
//   rows of the mini-batch after next into a two-stage raw ring (each warp its
//   own CS / 4 rows), and prepare the next one (L2-norm, rope, target LN, eta,
//   two rows at a time at 16 lanes a row; then attn = bf16(XQ XK^T) on the
//   tensor cores, 16 x 16 over k = 128, handed over negated as the A fragment
//   of Z1_bar's attn @ Gs) into a two-stage ring signalled by full/empty
//   mbarriers.
// - Operands are rounded to bf16 exactly where _linear_kernel calls
//   .astype(dt): XQ and XK after preprocessing, W for Z1 and XQ W, Gs, attn.
//   Only the fp32 summation order differs from the plain version.
// - 12 warps leave 168 registers a thread: no setmaxnreg.
// The mini-batches the kernels are built for are the cases of with_mini_batch
// below, which ops/ttt_linear_kernel.py's F128_MINI_BATCHES names (a test holds
// the two together); the C entries refuse any other.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"

namespace tttl128 {

using bf16 = __nv_bfloat16;
using hopper::mma_bf16_16816;
using hopper::pack_bf16;
using tttb::ScanArgs;

constexpr int kF = 128;
constexpr int kSlab = 16;                        // tokens of one m16 tile
constexpr int kWarps = 8;                        // consumer warps
constexpr int kConsumers = 32 * kWarps;          // consumer threads
constexpr int kProducers = 128;                  // producer threads (4 warps)
constexpr int kThreads = kConsumers + kProducers;
constexpr int kRowLanes = 16;                    // lanes of one row in the row phases, 8 features each
constexpr int kLdB = kF + 8;                     // row pitch of the bf16 tiles (272 bytes)
constexpr int kLdZ = kF + 4;                     // row pitch of the fp32 tiles (528 bytes)
constexpr int kConsumerBar = 1;                  // named barrier of the consumer warps
constexpr int kProducerBar = 2;                  // named barrier of the producer warps
constexpr uint32_t kSignBits = 0x80008000u;

// Call fn(std::integral_constant<int, CS>) for mini-batch cs; an error code for a CS the kernels are not built for.
template <typename Fn>
inline int with_mini_batch(int cs, Fn&& fn) {
  switch (cs) {
    case 16: return fn(std::integral_constant<int, 16>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NS>
struct RawStage {  // one mini-batch as loaded, for one (batch, head)
  static constexpr int kCS = kSlab * NS;
  bf16 q[kCS * kF], k[kCS * kF], v[kCS * kF];
  float cos[kCS * kF], sin[kCS * kF];
  float gate[kCS];
};

template <int NS>
struct PrepStage {  // one mini-batch as the step takes it
  static constexpr int kCS = kSlab * NS;
  bf16 xq[kCS * kLdB], xk[kCS * kLdB];  // bf16(XQ), bf16(XK)
  float tgt[kCS * kF];                  // LN-reconstruction target
  float eta[kCS];
  uint32_t neg_attn[NS * NS * 128];     // -bf16(XQ XK^T): block (s, j) as an mma A fragment, lane-major, at 128 (NS s + j)
};

// One pass-A step of K6@F128 as its pass B reads it back: the bf16 part and the fp32 part (two workspaces), each a
// byte image of the tiles above.
template <int NS>
struct StashH {
  static constexpr int kCS = kSlab * NS;
  bf16 wt[kF * kLdB];  // bf16(W^T) [c][k] before the step
  bf16 xq[kCS * kLdB], xk[kCS * kLdB], gs[kCS * kLdB];
  uint32_t neg_attn[NS * NS * 128];
};
template <int NS>
struct StashF {
  static constexpr int kCS = kSlab * NS;
  float z1[kCS * kLdZ], zb1[kCS * kLdZ];  // Z1 and Z1_bar (b included)
};
static_assert(sizeof(RawStage<1>) % 16 == 0 && sizeof(PrepStage<1>) % 16 == 0 && sizeof(StashH<1>) % 16 == 0 &&
                  sizeof(StashF<1>) % 16 == 0,
              "16-byte aligned stages and stash images");

template <int kLanes>
__device__ __forceinline__ float group_sum(float v) {  // sum over kLanes neighbouring lanes
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void ld_bf16(float (&x)[8], const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = v.x;
    x[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void ld_f32(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void st_f32(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void st_bf16(bf16* p, const float (&x)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// ---- fragment loaders (row pitch kLdB)
// A fragment of the 16 x 16 block at rows r0.., columns k0.. of a row-major tile.
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int r0, int k0, int lane) {
  hopper::ldsm_x4(a, hopper::ldsm_row(t + r0 * kLdB, kLdB, k0, lane));
}

// B fragments (b[0], b[1]: n-tile n0; b[2], b[3]: n-tile n0 + 8) of k-tile k0.. from a [k][n] row-major tile.
// Reordered {b[0], b[2], b[1], b[3]} they are the A fragment of the 16 x 16 block (rows n0.., columns k0..) of the
// tile's transpose.
__device__ __forceinline__ void ldb_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0, int lane) {
  hopper::ldsm_x4_trans(b, hopper::ldsm_row(t + k0 * kLdB, kLdB, n0, lane));
}

// The same from an [n][k] row-major tile (B = the tile transposed).
__device__ __forceinline__ void ldb_nk(uint32_t (&b)[4], const bf16* t, int n0, int k0, int lane) {
  hopper::ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdB + k0 + ((lane >> 3) & 1) * 8);
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

// ---- the producer
// cp.async rows row0 .. row0 + rows - 1 of mini-batch n (q/k/v, the rope rows, gate) into ``r``, 16-byte chunks
// over the warp's 32 lanes; the caller commits. row0 and rows are multiples of 4.
template <int CS>
__device__ __forceinline__ void load_rows(RawStage<CS / kSlab>& r, const ScanArgs& a, int b, int h, int n, int row0,
                                          int rows, int lane) {
  const size_t HF = (size_t)a.H * kF;
  const size_t x0 = ((size_t)b * a.NC + n) * CS * HF + (size_t)h * kF;
  for (int i = lane; i < rows * (kF / 8); i += 32) {
    const int row = row0 + i / (kF / 8), c = (i % (kF / 8)) * 8;
    const size_t go = x0 + row * HF + c;
    const int so = row * kF + c;
    hopper::cp_async16(r.q + so, a.xq + go);
    hopper::cp_async16(r.k + so, a.xk + go);
    hopper::cp_async16(r.v + so, a.xv + go);
  }
  const size_t t0 = ((size_t)n * CS + row0) * kF;
  for (int i = lane; i < rows * kF / 4; i += 32) {
    hopper::cp_async16(r.cos + row0 * kF + 4 * i, a.cos + t0 + 4 * i);
    hopper::cp_async16(r.sin + row0 * kF + 4 * i, a.sin + t0 + 4 * i);
  }
  const size_t g0 = (((size_t)b * a.H + h) * a.NC + n) * CS + row0;
  for (int i = lane; i < rows / 4; i += 32) hopper::cp_async16(r.gate + row0 + 4 * i, a.gate + g0 + 4 * i);
}

// L2-norm and rope of 8 features (pairs interleaved) of one row held by kRowLanes lanes: x / max(||x||, 1e-12),
// then x*cos + (x@R)*sin with (x@R) = (-x1, x0).
__device__ __forceinline__ void l2norm_rope(float (&y)[8], const float (&x)[8], const float (&c)[8],
                                            const float (&s)[8]) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) ss += x[i] * x[i];
  const float d = fmaxf(sqrtf(group_sum<kRowLanes>(ss)), 1e-12f);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const float x0 = x[i] / d, x1 = x[i + 1] / d;
    y[i] = x0 * c[i] + (-x1) * s[i];
    y[i + 1] = x1 * c[i + 1] + x0 * s[i + 1];
  }
}

// The LN-reconstruction target from t = v - XK (unbiased std, eps added to the std): t_hat = (t - mu) / sd;
// returns sd.
__device__ __forceinline__ float target_ln(float (&that)[8], const float (&t)[8]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += t[i];
  const float mu = group_sum<kRowLanes>(s) * (1.f / kF);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) v += (t[i] - mu) * (t[i] - mu);
  const float sd = sqrtf(group_sum<kRowLanes>(v) * (1.f / kF) * ((float)kF / (kF - 1))) + 1e-8f;
#pragma unroll
  for (int i = 0; i < 8; ++i) that[i] = (t[i] - mu) / sd;
  return sd;
}

// (x - mu) / std with std = sqrt(biased var + 1e-8) over a 128-wide row held by kRowLanes lanes; returns std.
__device__ __forceinline__ float ln_stats(float (&xh)[8], const float (&x)[8]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  const float mu = group_sum<kRowLanes>(s) * (1.f / kF);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) v += (x[i] - mu) * (x[i] - mu);
  const float sd = sqrtf(group_sum<kRowLanes>(v) * (1.f / kF) + 1e-8f);
#pragma unroll
  for (int i = 0; i < 8; ++i) xh[i] = (x[i] - mu) / sd;
  return sd;
}

// L2-norm, rope, target LN and eta of producer warp pw's rows 4 NS pw .. 4 NS pw + 4 NS - 1, two at a time:
// lane = row 4 NS pw + 2 i + lane / 16, features 8 (lane % 16) .. + 7. kStash: the rows' bf16 XQ and XK also go
// to ``stash``.
template <int CS, bool kStash>
__device__ __forceinline__ void prepare_rows(PrepStage<CS / kSlab>& p, const RawStage<CS / kSlab>& r, float eta_scale,
                                             const float (&lw)[8], const float (&lb)[8], int pw, int lane,
                                             StashH<CS / kSlab>* stash) {
  constexpr int NS = CS / kSlab;
  const int f = 8 * (lane % kRowLanes);
#pragma unroll 1
  for (int i = 0; i < 2 * NS; ++i) {
    const int row = 4 * NS * pw + 2 * i + lane / kRowLanes;
    float q[8], k[8], v[8], c[8], s[8], xq[8], xk[8], t[8], th[8];
    ld_bf16(q, r.q + row * kF + f);
    ld_bf16(k, r.k + row * kF + f);
    ld_bf16(v, r.v + row * kF + f);
    ld_f32(c, r.cos + row * kF + f);
    ld_f32(s, r.sin + row * kF + f);
    l2norm_rope(xq, q, c, s);
    l2norm_rope(xk, k, c, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = v[j] - xk[j];
    target_ln(th, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = lw[j] * th[j] + lb[j];
    st_f32(p.tgt + row * kF + f, t);
    st_bf16(p.xq + row * kLdB + f, xq);
    st_bf16(p.xk + row * kLdB + f, xk);
    if constexpr (kStash) {
      st_bf16(stash->xq + row * kLdB + f, xq);
      st_bf16(stash->xk + row * kLdB + f, xk);
    }
    if (lane % kRowLanes == 0) p.eta[row] = (1.f / (1.f + expf(-r.gate[row]))) * eta_scale;
  }
}

// attn = bf16(XQ XK^T) on the tensor cores, block (s, j) = i by producer warp i % 4, stored negated as the A
// fragment of the step's attn @ Gs (kStash: there and at ``stash``).
template <int NS, bool kStash>
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
    if constexpr (kStash) *reinterpret_cast<uint4*>(stash + i * 128 + lane * 4) = na;
  }
}

// Producer warp pw (of 4) prepares mini-batches n0 .. n0 + count - 1 into the two-stage ring; ``it0`` is the
// number of mini-batches the ring has carried before (its stages and mbarrier phases continue from there). kStash
// (K6@F128's pass A): each prepared XQ, XK and -attn also goes to stash[i].
template <int CS, bool kStash>
__device__ void producer(RawStage<CS / kSlab>* raw, PrepStage<CS / kSlab>* prep, uint64_t* full, uint64_t* empty,
                         const ScanArgs& a, const float* ln_w, const float* ln_b, int b, int h, int n0, int count,
                         int it0, int pw, int lane, StashH<CS / kSlab>* stash) {
  constexpr int NS = CS / kSlab, kRows = 4 * NS;
  const int f = 8 * (lane % kRowLanes);
  float lw[8], lb[8];
  ld_f32(lw, ln_w + (size_t)h * kF + f);
  ld_f32(lb, ln_b + (size_t)h * kF + f);
  load_rows<CS>(raw[it0 & 1], a, b, h, n0, kRows * pw, kRows, lane);
  hopper::cp_async_commit();
  for (int i = 0; i < count; ++i) {
    const int it = it0 + i, s = it & 1;
    __syncwarp();  // every lane is done with the raw stage it refills
    if (i + 1 < count) {
      load_rows<CS>(raw[s ^ 1], a, b, h, n0 + i + 1, kRows * pw, kRows, lane);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncwarp();  // this warp's rows of raw[s] have landed
    if (it >= 2) hopper::mbar_wait(&empty[s], ((it >> 1) - 1) & 1);
    prepare_rows<CS, kStash>(prep[s], raw[s], a.eta_scale, lw, lb, pw, lane, kStash ? stash + i : nullptr);
    hopper::named_sync(kProducerBar, kProducers);
    prepare_attn<NS, kStash>(prep[s], pw, lane, kStash ? stash[i].neg_attn : nullptr);
    hopper::mbar_arrive(&full[s]);
  }
}

// ---- the consumers
// Warp w, lane = 4 g + t. w[f][..]: W^T rows c = 16 w + g (elements 0, 1) and 16 w + g + 8 (2, 3), columns
// k = 8 f + 2t, 8 f + 2t + 1. bias[u]: b of columns 16 w + 8 u + 2t, + 1 (the same in the 8 lanes of a t).
struct LinState {
  float w[kF / 8][4];
  float2 bias[2];
};

// The B fragment (k-tile f / 2, n-tile u) of X @ bf16(W): pairs of W^T row 16 w + 8 u + g.
__device__ __forceinline__ uint32_t state_b(const float (&w)[kF / 8][4], int u, int f) {
  return pack_bf16(w[f][2 * u], w[f][2 * u + 1]);
}

// Load the state from W [F][F] (W[k][c]) and b [F] fp32; save it back (K5-train's checkpoints, K6's dW and db).
__device__ __forceinline__ void load_state(LinState& st, const float* W, const float* b, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < kF / 8; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = 16 * warp + g + 8 * hr, k = 8 * f + 2 * t;
      st.w[f][2 * hr] = W[k * kF + c];
      st.w[f][2 * hr + 1] = W[(k + 1) * kF + c];
    }
#pragma unroll
  for (int u = 0; u < 2; ++u) st.bias[u] = *reinterpret_cast<const float2*>(b + 16 * warp + 8 * u + 2 * t);
}

__device__ __forceinline__ void save_state(const float (&w)[kF / 8][4], const float2 (&bias)[2], float* W, float* b,
                                           int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < kF / 8; ++f)
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
__device__ __forceinline__ void store_wt(bf16* dst, const float (&w)[kF / 8][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < kF / 8; ++f)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(dst + (16 * warp + g + 8 * hr) * kLdB + 8 * f + 2 * t) =
          pack_bf16(w[f][2 * hr], w[f][2 * hr + 1]);
}

// w[f] += A @ Y[0..15, 8 f ..]: A a 16 (rows of W^T) x 16 (tokens) fragment, Y the 16 rows of one slab of a
// token-major [CS][kLdB] tile, all 128 columns.
__device__ __forceinline__ void update_rows(float (&w)[kF / 8][4], const uint32_t (&a)[4], const bf16* Y, int lane) {
#pragma unroll
  for (int fp = 0; fp < kF / 16; ++fp) {
    uint32_t yb[4];
    ldb_kn(yb, Y, 0, 16 * fp, lane);
    mma_bf16_16816(w[2 * fp], a, yb[0], yb[1]);
    mma_bf16_16816(w[2 * fp + 1], a, yb[2], yb[3]);
  }
}

// One mini-batch step of the consumer warps on the prepared stage ``p``, through the shared-memory tiles of ``T``
// (a struct with the arrays z [CS][kLdZ] (Z1), gs [CS][kLdB] (Gs) and, with the output, zb [CS][kLdZ] (Z1_bar);
// taken as the kernel's own struct, so the tiles' addresses stay offsets from one base). kOut: out = XQ +
// LN(Z1_bar) into the token-major rows at ``out`` (row stride HF). kStash: bf16(W^T), Gs, Z1 and Z1_bar of the
// step into sh / sf.
template <int CS, bool kOut, bool kStash, class Tiles>
__device__ __forceinline__ void step(LinState& st, const PrepStage<CS / kSlab>& p, Tiles& T,
                                     const float (&lw)[8], const float (&lb)[8], bf16* out, size_t HF,
                                     StashH<CS / kSlab>* sh, StashF<CS / kSlab>* sf, int warp, int lane) {
  constexpr int NS = CS / kSlab;
  const int c0 = 16 * warp;
  if constexpr (kStash) store_wt(sh->wt, st.w, warp, lane);

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
    if constexpr (kStash) store_block(sf->z1 + kSlab * s * kLdZ, z[s], c0, lane);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (1) Z1's rows

  // Gs = bf16(eta * ln_fused_l2_bwd(Z1, target)), eps 1e-8 on the biased variance, in the forward's form
  // (1/F) (F gx - sum gx - xh sum(gx xh)) / sd. Rows 16 s + 2 warp + lane / 16, features 8 (lane % 16) ...
  const int f = 8 * (lane % kRowLanes);
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int row = kSlab * s + 2 * warp + lane / kRowLanes;
    float x[8], xh[8], tg[8], gx[8];
    ld_f32(x, T.z + row * kLdZ + f);
    ld_f32(tg, p.tgt + row * kF + f);
    const float sd = ln_stats(xh, x);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gx[i] = (lw[i] * xh[i] + lb[i] - tg[i]) * lw[i];
      s1 += gx[i];
      s2 += gx[i] * xh[i];
    }
    s1 = group_sum<kRowLanes>(s1);
    s2 = group_sum<kRowLanes>(s2);
    const float eta = p.eta[row];
#pragma unroll
    for (int i = 0; i < 8; ++i) gx[i] = eta * ((1.f / kF) * (kF * gx[i] - s1 - xh[i] * s2) / sd);
    st_bf16(T.gs + row * kLdB + f, gx);
    if constexpr (kStash) st_bf16(sh->gs + row * kLdB + f, gx);
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
    if constexpr (kOut) store_block(T.zb + kSlab * s * kLdZ, q[s], c0, lane);
    if constexpr (kStash) store_block(sf->zb1 + kSlab * s * kLdZ, q[s], c0, lane);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    // Gs^T rows c0.., tokens of slab j (an A fragment), negated; times the slab's XK rows, all 128 columns.
    uint32_t a[4] = {gb[j][0] ^ kSignBits, gb[j][2] ^ kSignBits, gb[j][1] ^ kSignBits, gb[j][3] ^ kSignBits};
    update_rows(st.w, a, p.xk + kSlab * j * kLdB, lane);
  }
  if constexpr (kOut) {
    hopper::named_sync(kConsumerBar, kConsumers);  // (3) Z1_bar's rows

    // out = XQ + LN(Z1_bar), eps 1e-8 on the biased variance.
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      const int row = kSlab * s + 2 * warp + lane / kRowLanes;
      float x[8], xh[8], xq[8];
      ld_f32(x, T.zb + row * kLdZ + f);
      ld_bf16(xq, p.xq + row * kLdB + f);
      ln_stats(xh, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = xq[i] + (lw[i] * xh[i] + lb[i]);
      st_bf16(out + row * HF + f, x);
    }
  }
}

}  // namespace tttl128
