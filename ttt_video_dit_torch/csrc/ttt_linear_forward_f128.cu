// Fused TTT-linear forward scan for sampling (K5, no state checkpoints),
// head_dim F = 128, mini-batch CS = 16, bf16 q/k/v, for Hopper (sm_90a).
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
// the limit: the call moves the same ~0.89 GB of q/k/v/out as at F = 64 with
// 48 heads (0.27 ms at 3.35 TB/s). At B = 2 and 24 heads the grid is 48
// blocks on 132 SMs.
//
// Design: ttt_linear_step.cuh's tensor-core step, widened to 128. A source of
// its own, so that no head-dim-64 kernel changes. One block of 12 warps per
// (batch, head):
// - 8 consumer warps keep the fp32 state W^T (128 x 128, 64 KiB) in mma.sync
//   m16n8k16 accumulator registers: warp w owns rows c = 16 w .. 16 w + 15 of
//   W^T (the output columns c of XK W), 64 registers a thread. Packed to bf16
//   pairs they are the B fragments of Z1 = XK W + b and XQ W, so each warp
//   computes its own 16-column block of every product with no cross-warp
//   sum; the update W^T -= Gs^T XK accumulates into the same registers after
//   Z1_bar has used the old W. The consumers meet at 3 named barriers a step
//   (id 1, 256 threads).
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
// - Shared memory at CS 16: 2 raw stages of 28 KiB (bf16 q/k/v, fp32 rope
//   rows), 2 prepared ones of 17 KiB, the step's tiles 21 KiB: 111 KiB.
//   12 warps leave 168 registers a thread: no setmaxnreg.
// The mini-batches it is built for are the cases of with_mini_batch below,
// which ops/ttt_linear_kernel.py's F128_MINI_BATCHES names (a test holds the
// two together); the C entry refuses any other.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*128] bf16 (head h = columns
// 128 h .. 128 h + 127); gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope
// cos/sin [NC, CS, 128] f32; ln_w/ln_b [H, 128] f32; W1 [H, 128, 128], b1
// [H, 1, 128] f32 (the initial state, shared by every batch element). Every
// pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"

namespace {

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

// Call fn(std::integral_constant<int, CS>) for mini-batch cs; an error code for a CS the kernel is not built for.
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

template <int NS>
struct Smem {
  static constexpr int kCS = kSlab * NS;
  RawStage<NS> raw[2];
  PrepStage<NS> prep[2];
  float z[kCS * kLdZ], zb[kCS * kLdZ];
  bf16 gs[kCS * kLdB];
  uint64_t full[2], empty[2];
};
static_assert(sizeof(RawStage<1>) % 16 == 0 && sizeof(PrepStage<1>) % 16 == 0, "16-byte aligned stages");
static_assert(sizeof(Smem<1>) <= 232448, "exceeds the 227 KB shared-memory opt-in");

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

// The LN-reconstruction target from t = v - XK (unbiased std, eps added to the std): t_hat = (t - mu) / sd.
__device__ __forceinline__ void target_ln(float (&that)[8], const float (&t)[8]) {
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
// lane = row 4 NS pw + 2 i + lane / 16, features 8 (lane % 16) .. + 7.
template <int CS>
__device__ __forceinline__ void prepare_rows(PrepStage<CS / kSlab>& p, const RawStage<CS / kSlab>& r, float eta_scale,
                                             const float (&lw)[8], const float (&lb)[8], int pw, int lane) {
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
    if (lane % kRowLanes == 0) p.eta[row] = (1.f / (1.f + expf(-r.gate[row]))) * eta_scale;
  }
}

// attn = bf16(XQ XK^T) on the tensor cores, block (s, j) = i by producer warp i % 4, stored negated as the A
// fragment of the step's attn @ Gs.
template <int NS>
__device__ __forceinline__ void prepare_attn(PrepStage<NS>& p, int pw, int lane) {
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
    *reinterpret_cast<uint4*>(p.neg_attn + i * 128 + lane * 4) =
        make_uint4(pack_bf16(acc[0][0], acc[0][1]) ^ kSignBits, pack_bf16(acc[0][2], acc[0][3]) ^ kSignBits,
                   pack_bf16(acc[1][0], acc[1][1]) ^ kSignBits, pack_bf16(acc[1][2], acc[1][3]) ^ kSignBits);
  }
}

// Producer warp pw (of 4) prepares mini-batches 0 .. NC - 1 into the two-stage ring.
template <int CS>
__device__ void producer(Smem<CS / kSlab>& S, const ScanArgs& a, const float* ln_w, const float* ln_b, int b, int h,
                         int pw, int lane) {
  constexpr int NS = CS / kSlab, kRows = 4 * NS;
  const int f = 8 * (lane % kRowLanes);
  float lw[8], lb[8];
  ld_f32(lw, ln_w + (size_t)h * kF + f);
  ld_f32(lb, ln_b + (size_t)h * kF + f);
  load_rows<CS>(S.raw[0], a, b, h, 0, kRows * pw, kRows, lane);
  hopper::cp_async_commit();
  for (int n = 0; n < a.NC; ++n) {
    const int s = n & 1;
    __syncwarp();  // every lane is done with the raw stage it refills
    if (n + 1 < a.NC) {
      load_rows<CS>(S.raw[s ^ 1], a, b, h, n + 1, kRows * pw, kRows, lane);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncwarp();  // this warp's rows of raw[s] have landed
    if (n >= 2) hopper::mbar_wait(&S.empty[s], ((n >> 1) - 1) & 1);
    prepare_rows<CS>(S.prep[s], S.raw[s], a.eta_scale, lw, lb, pw, lane);
    hopper::named_sync(kProducerBar, kProducers);
    prepare_attn<NS>(S.prep[s], pw, lane);
    hopper::mbar_arrive(&S.full[s]);
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

// Load the state from W [F][F] (W[k][c]) and b [F] fp32.
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

// One mini-batch step of the consumer warps on the prepared stage ``p``: out = XQ + LN(Z1_bar) into the
// token-major rows at ``out`` (row stride HF).
template <int CS>
__device__ __forceinline__ void step(LinState& st, const PrepStage<CS / kSlab>& p, Smem<CS / kSlab>& S,
                                     const float (&lw)[8], const float (&lb)[8], bf16* out, size_t HF, int warp,
                                     int lane) {
  constexpr int NS = CS / kSlab;
  const int c0 = 16 * warp;

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
    store_block(S.z + kSlab * s * kLdZ, z[s], c0, lane);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (1) Z1's rows

  // Gs = bf16(eta * ln_fused_l2_bwd(Z1, target)), eps 1e-8 on the biased variance, in the forward's form
  // (1/F) (F gx - sum gx - xh sum(gx xh)) / sd. Rows 16 s + 2 warp + lane / 16, features 8 (lane % 16) ...
  const int f = 8 * (lane % kRowLanes);
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int row = kSlab * s + 2 * warp + lane / kRowLanes;
    float x[8], xh[8], tg[8], gx[8];
    ld_f32(x, S.z + row * kLdZ + f);
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
    st_bf16(S.gs + row * kLdB + f, gx);
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (2) Gs

  // b -= colsum(Gs); Z1_bar = XQ @ bf16(W) - attn @ Gs + b; W^T -= Gs^T @ XK.
  uint32_t gb[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j) ldb_kn(gb[j], S.gs, kSlab * j, c0, lane);  // B fragments of Gs's columns c0.., slab j
  {
    const int g = lane >> 2, t = lane & 3;
    float cs[2][2] = {};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int r0 = kSlab * j + g, r1 = r0 + 8;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(S.gs + r0 * kLdB + c0 + 8 * u + 2 * t));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(S.gs + r1 * kLdB + c0 + 8 * u + 2 * t));
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
    store_block(S.zb + kSlab * s * kLdZ, q[s], c0, lane);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    // Gs^T rows c0.., tokens of slab j (an A fragment), negated; times the slab's XK rows, all 128 columns.
    uint32_t a[4] = {gb[j][0] ^ kSignBits, gb[j][2] ^ kSignBits, gb[j][1] ^ kSignBits, gb[j][3] ^ kSignBits};
    const bf16* Y = p.xk + kSlab * j * kLdB;
#pragma unroll
    for (int fp = 0; fp < kF / 16; ++fp) {
      uint32_t yb[4];
      ldb_kn(yb, Y, 0, 16 * fp, lane);
      mma_bf16_16816(st.w[2 * fp], a, yb[0], yb[1]);
      mma_bf16_16816(st.w[2 * fp + 1], a, yb[2], yb[3]);
    }
  }
  hopper::named_sync(kConsumerBar, kConsumers);  // (3) Z1_bar's rows

  // out = XQ + LN(Z1_bar), eps 1e-8 on the biased variance.
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    const int row = kSlab * s + 2 * warp + lane / kRowLanes;
    float x[8], xh[8], xq[8];
    ld_f32(x, S.zb + row * kLdZ + f);
    ld_bf16(xq, p.xq + row * kLdB + f);
    ln_stats(xh, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = xq[i] + (lw[i] * xh[i] + lb[i]);
    st_bf16(out + row * HF + f, x);
  }
}

struct Args {
  ScanArgs a;
  const float *ln_w, *ln_b, *W1, *b1;
  bf16* out;
};

template <int CS>
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
    producer<CS>(S, A.a, A.ln_w, A.ln_b, b, h, warp - kWarps, lane);
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
    hopper::mbar_wait(&S.full[s], (n >> 1) & 1);
    step<CS>(st, S.prep[s], S, lw, lb, A.out + ((size_t)b * NC + n) * CS * HF + (size_t)h * kF, HF, warp, lane);
    hopper::mbar_arrive(&S.empty[s]);
  }
}

}  // namespace

// Shared memory of the instantiation for mini-batch cs (an error code for a CS it is not built for).
extern "C" int ttt_linear_forward_f128_smem_bytes(int cs) {
  return with_mini_batch(cs, [](auto c) { return (int)sizeof(Smem<decltype(c)::value / kSlab>); });
}

extern "C" int ttt_linear_forward_f128(const void* xq, const void* xk, const void* xv, const void* gate,
                                       const void* rope_cos, const void* rope_sin, const void* ln_w,
                                       const void* ln_b, const void* W1, const void* b1, void* out, int B, int NC,
                                       int H, int CS, float eta_scale, void* stream) {
  const Args A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                static_cast<const float*>(rope_sin), NC, H, eta_scale},
               static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
               static_cast<const float*>(b1), static_cast<bf16*>(out)};
  return with_mini_batch(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value;
    constexpr int kBytes = sizeof(Smem<kMiniBatch / kSlab>);
    cudaError_t err = cudaFuncSetAttribute(ttt_linear_fwd_f128_kernel<kMiniBatch>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ttt_linear_fwd_f128_kernel<kMiniBatch><<<B * H, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
