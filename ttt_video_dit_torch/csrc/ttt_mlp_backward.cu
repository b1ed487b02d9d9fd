// Fused TTT-MLP backward (K2), head_dim F = 64, mini-batch CS = 8, 16, ...,
// 64 (one instantiation each, ttt_mlp_block.cuh:with_slabs), for Hopper
// (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_mlp_bwd_kernel
// (launched by ttt_mlp_backward, l.750, and reduced by
// ttt_vjp.py:_mlp_bwd_pre), in its fused-preprocessing, token-major,
// in-kernel-gate form. It is the VJP of the training forward scan
// (ttt_mlp_forward.cu:ttt_mlp_fwd_train_kernel) from that kernel's fp32 state
// checkpoints: per (batch, head) it walks the checkpoint groups last to first
// (the ragged group first); per group, pass A re-runs the forward from the
// group's checkpoint and stashes each step's state, and pass B walks the
// group backwards through the hand-derived step VJP (ttt_backward.py:270-414):
// the second-order LN term, GELU'', the preprocessing VJPs (target LN, rope,
// L2 norm) and the sigmoid gate, d_gate = de * eta * (1 - sigmoid).
//
// What bounds it on the H100: like the forward, the scan is sequential, so
// one block owns one (batch, head) and the limit is the latency of a step
// inside one SM (a pass-B step is ~40 dependent matrix products and a dozen
// row passes; ~60 Mflop with pass A), at B = 1 on 48 of the 132 SMs.
//
// Design: one block of 8 warps per (batch, head); every product runs on the
// tensor cores (mma.sync m16n8k16, bf16 operands rounded where the Pallas
// kernel calls .astype(dt), fp32 accumulation), through the fragment loaders
// of ttt_mlp_train_step.cuh.
// - Pass A is that header's forward step without the output: the fp32 state
//   in the registers (warp w owns hidden units 32w..32w+31). Before each step
//   it stashes bf16(W1^T) and bf16(W2) (64 KiB) and the fp32 biases in the
//   workspace; stashing in bf16 is exact, pass B uses W only rounded.
// - Pass B keeps the gradient carries dW1^T and dW2 in the registers in the
//   state's layout (128 a thread) and db1 beside them: every dW contribution
//   (Xb2c^T dZb2, XQ^T dZb1, dP^T g2, X2c^T dZ2, XK^T dZ1) is an update-shaped
//   product accumulated in place, and step (6)'s products read the carries
//   before this step's contributions are added. While pass A re-runs a group
//   the carries wait in the workspace (128 KiB a scan, once a group).
// - Pass B's bf16 operand tiles live in shared memory (~216 KiB at CS 64,
//   ~133 KiB at 16; Smem<NS>): the step's
//   stashed W1^T and W2 (cp.async), X2c, G1, one tile that holds in turn
//   Xb2c, dZb1, dP and dZ1 (and, for step (6), bf16 copies of the carries),
//   XQ, XK, G2, bf16(g2), dZb2 then dZ2. The [CS][CS] matrices (attn1,
//   attn2, dA1, dA2 and their transposes) are recomputed as A fragments
//   where a product needs them rather than stored. Products over a warp's own
//   units run slab by slab; products into [CS][F] run as 16 x 32 blocks, one
//   a warp for the 2 NS warps that own one (ts::owns_block); the row passes
//   (LayerNorms and their VJPs, the preprocessing VJPs) take CS / 8 rows a
//   warp. The fp32 per-step values that do not fit on chip ([CS][4F] Z1, P,
//   Zb1, dX2, dZ1 in each thread's fragment order; [CS][F] rows; the
//   LN-parameter sums) go through the workspace (Work<NS>), which stays in
//   the L2 (~1.6 MiB a scan at CS 64 and K = 16, the stash 1 MiB of it: the
//   stash is 64 KiB a step at every CS).
// - No producer warpgroup: with 8 warps each thread may hold 255 registers,
//   which the carries and the recomputed fragments need; the 8 warps prepare
//   each mini-batch themselves (2 NS rows each) at the start of its step.
// - A half slab (CS 8, 24, 40, 56): the padding is prepared as XQ = XK = 0,
//   target 0 and eta 0 (ttt_mlp_train_step.cuh), so G1, G2 and every
//   cotangent that eta scales are 0 there; the row passes of the VJP write
//   its rows of dZb2c and dZ2c as 0 and load and store nothing of it.
// The ln and bias gradients come out compact ([F], [4F]) per (batch, head);
// the wrapper sums them over the batch.
//
// Layouts: as ttt_mlp_forward.cu; dout/dxq/dxk/dxv [B, NC, CS, H*F] bf16;
// dgate [B, H, NC, CS] f32; checkpoints W1 [B, H, NG, F, 4F], b1
// [B, H, NG, 1, 4F], W2 [B, H, NG, 4F, F], b2 [B, H, NG, 1, F] f32; outputs
// dW1 [B, H, F, 4F], db1 [B, H, 1, 4F], dW2 [B, H, 4F, F], db2 [B, H, 1, F],
// dln_w/dln_b [B, H, F] f32. Every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"
#include "ttt_mlp_train_step.cuh"

namespace {

namespace ts = ttts;
using ts::bf16;
using ts::kF;
using ts::kF4;
using ts::pack_bf16;
using tttb::warp_sum;

constexpr int kWarps = ts::kWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kState = kF * kF4;
constexpr int kWRows = ts::tile_elems<kF>(kF4);

template <int NS>
struct Smem {
  static constexpr int kCS = ts::kSlab * NS, kTok = ts::tile_elems<kF>(kCS), kWide = ts::tile_elems<kF4>(kCS);
  // e holds a [CS][4F] tile, a carry's bf16 copy [4F][F] (block_mm_sw) and pass A's fp32 Z2 rows: below CS 64 the
  // carry's copy is the largest.
  static constexpr int kE = kWide > kF4 * kF ? kWide : kF4 * kF;
  bf16 w1t[kWRows], w2[kWRows];  // bf16(W1^T), bf16(W2) of the step (pass A: w2 is the state's copy)
  bf16 x2c[kWide], g1[kWide];    // X2c, G1
  bf16 e[kE];                    // Xb2c -> dZb1c -> dPc -> dZ1c; the carries' copies; pass A: Z2's fp32 rows
  bf16 xq[kTok], xk[kTok];       // the prepared mini-batch
  bf16 g2[kTok], g2c[kTok];      // G2 = bf16(eta g2), bf16(g2) (pass A: G2 and bf16(grad_z2))
  bf16 dzc[kTok];                // dZb2c, then dZ2c
  float b1[kF4];                 // pass A: the state's b1; pass B: b1' = b1 - colsum(G1)
  static_assert(sizeof(float) * kCS * ts::kLdZ <= sizeof(bf16) * kE, "pass A's Z2 rows fit the e tile");
};
static_assert(sizeof(Smem<4>) <= 232448, "exceeds the 227 KB shared-memory opt-in");

// The per-(batch, head) workspace, in floats (then the bf16 stash).
template <int NS>
struct Work {
  static constexpr int kCS = ts::kSlab * NS;
  enum : int {
    kPark = 0,                                              // the carries while pass A runs, fragment order
    kZ1 = kPark + 2 * kState, kP = kZ1 + kCS * kF4,         // [CS][4F] in fragment order
    kZB1 = kP + kCS * kF4, kDX2 = kZB1 + kCS * kF4, kDZ1 = kDX2 + kCS * kF4,
    kTGT = kDZ1 + kCS * kF4, kTHAT = kTGT + kCS * kF,       // [CS][F] rows
    kZ2 = kTHAT + kCS * kF, kG2R = kZ2 + kCS * kF, kZB2 = kG2R + kCS * kF, kDXQ = kZB2 + kCS * kF,
    kDXK = kDXQ + kCS * kF, kDG2 = kDXK + kCS * kF, kDPW = kDG2 + kCS * kF, kDLNW = kDPW + kCS * kF,
    kDLNB = kDLNW + kCS * kF,
    kDB1 = kDLNB + kCS * kF, kDB1T = kDB1 + kF4,            // [4F]: the carry db1, db1_tot
    kETA = kDB1T + kF4, kSIG = kETA + kCS, kST = kSIG + kCS, kSTD2 = kST + kCS, kDB2 = kSTD2 + kCS,  // [CS]
    kPZB2 = kDB2 + kF, kPZ2 = kPZB2 + kWarps * kF, kPDE = kPZ2 + kWarps * kF,  // per-warp partial sums
    kB1S = kPDE + kWarps * kCS,                             // the stash: b1 [K][4F], b2 [K][F], then bf16 W
    kFixedFloats = kB1S,
  };
};

template <int NS>
long long workspace_bytes(int K) {
  const long long floats = (long long)Work<NS>::kFixedFloats + (long long)K * (kF4 + kF);
  const long long bytes = floats * 4 + (long long)K * kState * 2 * 2;
  return (bytes + 255) / 256 * 256;
}

struct BwdArgs {
  tttb::ScanArgs a;
  const float *ln_w, *ln_b, *w1_ck, *b1_ck, *w2_ck, *b2_ck;
  const bf16* dout;
  bf16 *dxq, *dxk, *dxv;
  float *dgate, *dW1, *db1, *dW2, *db2, *dlnw, *dlnb;
  unsigned char* work;
  long long work_bytes;
  int K;
};

__device__ __forceinline__ void sync() { __syncthreads(); }

template <int CS>
__device__ __forceinline__ size_t x_offset(const tttb::ScanArgs& a, int b, int h, int n, int r, int f) {
  return (((size_t)b * a.NC + n) * CS + r) * ((size_t)a.H * kF) + (size_t)h * kF + f;
}

// This thread's float4 of a [CS][4F] value in fragment order: warp, slab s, n-tile u.
template <int NS>
__device__ __forceinline__ float4* frag(float* base, int warp, int s, int u, int lane) {
  return reinterpret_cast<float4*>(base) + ((warp * NS + s) * 4 + u) * 32 + lane;
}

__device__ __forceinline__ float4 to4(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }

// The warp's 16 x 32 block (rows r0, columns c0) of a row-major [CS][F] fp32 array: = acc, or += acc.
template <bool kAdd>
__device__ __forceinline__ void block_to_rows(float* dst, const float (&acc)[4][4], int r0, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float2* p = reinterpret_cast<float2*>(dst + (r0 + g + 8 * hr) * kF + c0 + 8 * nt + 2 * t);
      const float2 v = kAdd ? *p : make_float2(0.f, 0.f);
      *p = make_float2(v.x + acc[nt][2 * hr], v.y + acc[nt][2 * hr + 1]);
    }
}

// Sum of v over the quad's rows (lanes 4g + t, the 8 values of g) for units 8u + 2t, 8u + 2t + 1: colsums of a
// slab's fragments, reduced over g.
__device__ __forceinline__ float reduce_g(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Park (or fetch) the carries dW1^T, dW2 in the workspace, each thread its own 128 floats.
__device__ __forceinline__ void park(float* dst, const ts::State& c, int tid) {
  float4* p = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      p[(m * 8 + f) * kThreads + tid] = to4(c.w1[m][f]);
      p[(16 + m * 8 + f) * kThreads + tid] = to4(c.w2[m][f]);
    }
}

__device__ __forceinline__ void unpark(ts::State& c, const float* src, int tid) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float4 a = p[(m * 8 + f) * kThreads + tid], b = p[(16 + m * 8 + f) * kThreads + tid];
      c.w1[m][f][0] = a.x, c.w1[m][f][1] = a.y, c.w1[m][f][2] = a.z, c.w1[m][f][3] = a.w;
      c.w2[m][f][0] = b.x, c.w2[m][f][1] = b.y, c.w2[m][f][2] = b.z, c.w2[m][f][3] = b.w;
    }
}

// One step of pass B for mini-batch n (stash entry i). gc: the carries w1 = dW1^T, w2 = dW2 (db1 and db2 live in
// the workspace).
template <int CS>
__device__ __forceinline__ void backward_step(Smem<ts::slabs(CS)>& S, float* G, const BwdArgs& A, int b, int h,
                                              int n, int i, ts::State& gc, int warp, int lane) {
  constexpr int NS = ts::slabs(CS), kCS = ts::kSlab * NS, kR = 2 * NS;  // kCS: the tiles' rows; kR: a warp's rows
  using W = Work<NS>;
  const int g = lane >> 2, t = lane & 3, f0 = 2 * lane, tid = threadIdx.x;
  const int sw = warp >> 1, r0 = 16 * sw, c0 = 32 * (warp & 1);
  const bool blk = ts::owns_block<NS>(warp);  // the warp computes the 16 x 32 block (r0, c0) of [CS][F] results
  const float* lnw_h = A.ln_w + (size_t)h * kF;
  const float* lnb_h = A.ln_b + (size_t)h * kF;
  const float2 lw = *reinterpret_cast<const float2*>(lnw_h + f0), lb = *reinterpret_cast<const float2*>(lnb_h + f0);
  const bf16* W1S = reinterpret_cast<const bf16*>(G + W::kB1S + (size_t)A.K * (kF4 + kF));
  const bf16* W2S = W1S + (size_t)A.K * kState;

  // ---- the step's inputs: the stashed bf16 W (cp.async) and biases, the prepared mini-batch.
  sync();  // the previous step is done with every tile
  for (int c = tid; c < 2 * kF4 * 8; c += kThreads) {
    const int which = c / (kF4 * 8), rr = (c >> 3) % kF4, ch = c & 7;
    hopper::cp_async16((which ? S.w2 : S.w1t) + rr * ts::pitch<kF>() + 8 * ch,
                       (which ? W2S : W1S) + (size_t)i * kState + rr * kF + 8 * ch);
  }
  hopper::cp_async_commit();
  const ts::Prep p{S.xq, S.xk, G + W::kTGT, G + W::kETA, G + W::kTHAT, G + W::kST, G + W::kSIG};
  ts::prepare_rows<CS, kR>(p, A.a, A.ln_w, A.ln_b, b, h, n, warp, lane);
  const float* b1_step = G + W::kB1S + (size_t)i * kF4;  // the stashed b1 of this step
  const float2 b2 = *reinterpret_cast<const float2*>(G + W::kB1S + (size_t)A.K * kF4 + (size_t)i * kF + f0);
  hopper::cp_async_wait<0>();
  sync();

  // ---- recompute the step's forward intermediates
  // Z1 = XK @ W1 + b1 (kept fp32); X2c = bf16(gelu(Z1)).
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    float z[4][4] = {};
    ts::unit_mm_w(z, S.xk, s, S.w1t, warp, lane);
    uint32_t x2[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 bb = ts::b1_pair(b1_step, warp, u, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) z[u][e] += (e & 1) ? bb.y : bb.x;
      *frag<NS>(G + W::kZ1, warp, s, u, lane) = to4(z[u]);
      x2[u][0] = pack_bf16(tttb::gelu_tanh(z[u][0]), tttb::gelu_tanh(z[u][1]));
      x2[u][1] = pack_bf16(tttb::gelu_tanh(z[u][2]), tttb::gelu_tanh(z[u][3]));
    }
    ts::store_slab(S.x2c, x2, s, warp, lane);
  }
  sync();
  if (blk) {  // Z2 = X2c @ W2 (b2 added in the row pass)
    float z2[4][4] = {};
    ts::block_mm<kF4, kF4, kF, false>(z2, S.x2c, r0, S.w2, c0, lane);
    block_to_rows<false>(G + W::kZ2, z2, r0, c0, lane);
  }
  sync();
  // Rows: z2_hat, std2; g2 = ln_fused_l2(Z2, target) (fp32 kept), bf16(g2), G2 = bf16(eta g2).
#pragma unroll 1
  for (int r = kR * warp; r < kR * warp + kR; ++r) {
    float2* zr = reinterpret_cast<float2*>(G + W::kZ2 + r * kF + f0);
    const float2 z = *zr;
    const float x0 = z.x + b2.x, x1 = z.y + b2.y;
    const float mu = warp_sum(x0 + x1) * (1.f / kF);
    const float sd = sqrtf(warp_sum((x0 - mu) * (x0 - mu) + (x1 - mu) * (x1 - mu)) * (1.f / kF) + 1e-8f);
    const float xh0 = (x0 - mu) / sd, xh1 = (x1 - mu) / sd;
    const float2 tg = *reinterpret_cast<const float2*>(G + W::kTGT + r * kF + f0);
    const float gx0 = lw.x * (lw.x * xh0 + lb.x - tg.x), gx1 = lw.y * (lw.y * xh1 + lb.y - tg.y);
    const float mg = warp_sum(gx0 + gx1) * (1.f / kF);
    const float m2 = warp_sum(gx0 * xh0 + gx1 * xh1) * (1.f / kF);
    const float g0 = (gx0 - mg - xh0 * m2) / sd, g1 = (gx1 - mg - xh1 * m2) / sd;
    const float eta = G[W::kETA + r];
    *zr = make_float2(xh0, xh1);
    if (lane == 0) G[W::kSTD2 + r] = sd;
    *reinterpret_cast<float2*>(G + W::kG2R + r * kF + f0) = make_float2(g0, g1);
    *reinterpret_cast<uint32_t*>(S.g2c + ts::swz<kF>(r, f0)) = pack_bf16(g0, g1);
    *reinterpret_cast<uint32_t*>(S.g2 + ts::swz<kF>(r, f0)) = pack_bf16(eta * g0, eta * g1);
  }
  sync();
  // P = bf16(g2) @ W2^T (kept); g1 = P gelu'(Z1); G1 = bf16(eta g1); b1' = b1 - colsum(G1).
  {
    float cs[4][2] = {};
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      float pp[4][4] = {};
      ts::unit_mm_w(pp, S.g2c, s, S.w2, warp, lane);
      const float eta_lo = G[W::kETA + 16 * s + g], eta_hi = G[W::kETA + 16 * s + g + 8];
      uint32_t g1[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        *frag<NS>(G + W::kP, warp, s, u, lane) = to4(pp[u]);
        const float4 z = *frag<NS>(G + W::kZ1, warp, s, u, lane);
        g1[u][0] = pack_bf16(eta_lo * (pp[u][0] * tttb::gelu_bwd(z.x)), eta_lo * (pp[u][1] * tttb::gelu_bwd(z.y)));
        g1[u][1] = pack_bf16(eta_hi * (pp[u][2] * tttb::gelu_bwd(z.z)), eta_hi * (pp[u][3] * tttb::gelu_bwd(z.w)));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][0]));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][1]));
        cs[u][0] += lo.x + hi.x;
        cs[u][1] += lo.y + hi.y;
      }
      ts::store_slab(S.g1, g1, s, warp, lane);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 bb = ts::b1_pair(b1_step, warp, u, lane);
      const float c0s = reduce_g(cs[u][0]), c1s = reduce_g(cs[u][1]);
      if (g == 0) *reinterpret_cast<float2*>(S.b1 + 32 * warp + 8 * u + 2 * t) = make_float2(bb.x - c0s, bb.y - c1s);
    }
    __syncwarp();
  }
  // Step (6)'s products over all units, from bf16 copies of the carries before this step's contributions:
  // dG2 = -X2c @ bf16(dW2), dXK = -G1 @ bf16(dW1)^T.
  ts::store_state_rows_sw(S.e, gc.w2, warp, lane);
  sync();
  if (blk) {
    float acc[4][4] = {};
    ts::block_mm_sw<true>(acc, S.x2c, r0, S.e, c0, lane);
    block_to_rows<false>(G + W::kDG2, acc, r0, c0, lane);
  }
  sync();
  ts::store_state_rows_sw(S.e, gc.w1, warp, lane);
  sync();
  if (blk) {
    float acc[4][4] = {};
    ts::block_mm_sw<true>(acc, S.g1, r0, S.e, c0, lane);
    block_to_rows<false>(G + W::kDXK, acc, r0, c0, lane);
  }
  sync();
  // Zb1 = XQ @ W1 - attn1 @ G1 + b1' (kept); Xb2c = bf16(gelu(Zb1)).
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    float zb[4][4] = {};
    ts::unit_mm_w(zb, S.xq, s, S.w1t, warp, lane);
    ts::unit_mm_xyt<kF, NS>(zb, S.xq, S.xk, s, true, S.g1, warp, lane);
    uint32_t xb[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 bb = ts::b1_pair(S.b1, warp, u, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) zb[u][e] += (e & 1) ? bb.y : bb.x;
      *frag<NS>(G + W::kZB1, warp, s, u, lane) = to4(zb[u]);
      xb[u][0] = pack_bf16(tttb::gelu_tanh(zb[u][0]), tttb::gelu_tanh(zb[u][1]));
      xb[u][1] = pack_bf16(tttb::gelu_tanh(zb[u][2]), tttb::gelu_tanh(zb[u][3]));
    }
    ts::store_slab(S.e, xb, s, warp, lane);
  }
  sync();
  if (blk) {  // Zb2 = Xb2c @ W2 - attn2 @ G2 (b2 - colsum(G2) added in the row pass)
    float acc[4][4] = {};
    ts::block_mm<kF4, kF4, kF, false>(acc, S.e, r0, S.w2, c0, lane);
    ts::block_mm_xyt<kF4, NS>(acc, S.e, S.x2c, sw, true, S.g2, c0, lane);
    block_to_rows<false>(G + W::kZB2, acc, r0, c0, lane);
  }
  sync();

  // ---- the step VJP
  // (1) out = XQ + LN(Zb2): dZb2 = ln_fwd_vjp; dXQ = d_out; dln_w, dln_b; colsum(dZb2) partials.
  {
    float2 cg = make_float2(0.f, 0.f), cz = make_float2(0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < kCS; ++r) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(S.g2 + ts::swz<kF>(r, f0)));
      cg.x += v.x;
      cg.y += v.y;
    }
#pragma unroll 1
    for (int r = kR * warp; r < kR * warp + kR; ++r) {
      if constexpr (ts::kHalf<CS>) {
        if (r >= CS) {  // a half slab's padding: dZb2 0 (and its dXQ rows, which (5) adds to)
          *reinterpret_cast<uint32_t*>(S.dzc + ts::swz<kF>(r, f0)) = 0u;
          *reinterpret_cast<float2*>(G + W::kDXQ + r * kF + f0) = make_float2(0.f, 0.f);
          continue;
        }
      }
      const float2 z = *reinterpret_cast<const float2*>(G + W::kZB2 + r * kF + f0);
      const float x0 = (z.x + b2.x) - cg.x, x1 = (z.y + b2.y) - cg.y;
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float sd = sqrtf(warp_sum((x0 - mu) * (x0 - mu) + (x1 - mu) * (x1 - mu)) * (1.f / kF) + 1e-8f);
      const float xh0 = (x0 - mu) / sd, xh1 = (x1 - mu) / sd;
      const float2 u =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(A.dout + x_offset<CS>(A.a, b, h, n, r, f0)));
      const float wv0 = lw.x * u.x, wv1 = lw.y * u.y;
      const float mw = warp_sum(wv0 + wv1) * (1.f / kF);
      const float mwx = warp_sum(wv0 * xh0 + wv1 * xh1) * (1.f / kF);
      const float d0 = (wv0 - mw - xh0 * mwx) / sd, d1 = (wv1 - mw - xh1 * mwx) / sd;
      float2* lnw = reinterpret_cast<float2*>(G + W::kDLNW + r * kF + f0);
      float2* lnb = reinterpret_cast<float2*>(G + W::kDLNB + r * kF + f0);
      *lnw = make_float2(lnw->x + u.x * xh0, lnw->y + u.y * xh1);
      *lnb = make_float2(lnb->x + u.x, lnb->y + u.y);
      *reinterpret_cast<float2*>(G + W::kDXQ + r * kF + f0) = u;
      *reinterpret_cast<uint32_t*>(S.dzc + ts::swz<kF>(r, f0)) = pack_bf16(d0, d1);
      cz.x += d0;
      cz.y += d1;
    }
    *reinterpret_cast<float2*>(G + W::kPZB2 + warp * kF + f0) = cz;
  }
  sync();
  // (2) dG2 -= attn2^T @ dZb2c + db2_tot (db2_tot = db2 + colsum(dZb2)).
  if (blk) {
    float acc[4][4] = {};
    ts::block_mm_xyt<kF4, NS>(acc, S.x2c, S.e, sw, false, S.dzc, c0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = c0 + 8 * nt + 2 * t;
      float2 d = *reinterpret_cast<const float2*>(G + W::kDB2 + c);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(G + W::kPZB2 + w * kF + c);
        d.x += v.x;
        d.y += v.y;
      }
      acc[nt][0] += d.x, acc[nt][1] += d.y, acc[nt][2] += d.x, acc[nt][3] += d.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = -acc[nt][e];
    }
    block_to_rows<true>(G + W::kDG2, acc, r0, c0, lane);
  }
  // (3) dX2 = bf16(dA2)^T @ Xb2c, dA2 = -dZb2c @ G2^T; (6) dX2 -= G2 @ bf16(dW2)^T (the carry before this step's).
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    float acc[4][4] = {};
    ts::unit_mm_xyt<kF, NS>(acc, S.g2, S.dzc, s, true, S.e, warp, lane);
    ts::slab_by_state<4, true>(acc, S.g2, s, gc.w2, lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) *frag<NS>(G + W::kDX2, warp, s, u, lane) = to4(acc[u]);
    ts::fence_state(gc.w2);
  }
  // (2) dW2 += Xb2c^T @ dZb2c.
  ts::rows_update<NS>(gc.w2, S.e, S.dzc, warp, lane);
  sync();  // every warp is done with e (the (2) products read all its columns); each warp's columns take dZb1c next
  // (2) dXb2 = dZb2c @ W2^T, (3) += bf16(dA2) @ X2c; (4) dZb1 = gelu'(Zb1) dXb2; db1_tot = db1 + colsum(dZb1).
  {
    float cs[4][2] = {};
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      float acc[4][4] = {};
      ts::unit_mm_w(acc, S.dzc, s, S.w2, warp, lane);
      ts::unit_mm_xyt<kF, NS>(acc, S.dzc, S.g2, s, true, S.x2c, warp, lane);
      uint32_t dz[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 zb = *frag<NS>(G + W::kZB1, warp, s, u, lane);
        const float d0 = tttb::gelu_bwd(zb.x) * acc[u][0], d1 = tttb::gelu_bwd(zb.y) * acc[u][1];
        const float d2 = tttb::gelu_bwd(zb.z) * acc[u][2], d3 = tttb::gelu_bwd(zb.w) * acc[u][3];
        cs[u][0] += d0 + d2;
        cs[u][1] += d1 + d3;
        dz[u][0] = pack_bf16(d0, d1);
        dz[u][1] = pack_bf16(d2, d3);
      }
      ts::store_slab(S.e, dz, s, warp, lane);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // db1_tot = db1 + colsum(dZb1)
      const float c0s = reduce_g(cs[u][0]), c1s = reduce_g(cs[u][1]);
      const float2 d = ts::b1_pair(G + W::kDB1, warp, u, lane);
      if (g == 0)
        *reinterpret_cast<float2*>(G + W::kDB1T + 32 * warp + 8 * u + 2 * t) = make_float2(d.x + c0s, d.y + c1s);
    }
    __syncwarp();
  }
  sync();
  // (5) dXQ += dZb1c @ W1^T, (7) += bf16(dA1) @ XK, dA1 = -dZb1c @ G1^T; dXK += bf16(dA1)^T @ XQ.
  if (blk) {
    float acc[4][4] = {};
    ts::block_mm<kF4, kF4, kF, false>(acc, S.e, r0, S.w1t, c0, lane);
    ts::block_mm_xyt<kF4, NS>(acc, S.e, S.g1, sw, true, S.xk, c0, lane);
    block_to_rows<true>(G + W::kDXQ, acc, r0, c0, lane);
  }
  if (blk) {
    float acc[4][4] = {};
    ts::block_mm_xyt<kF4, NS>(acc, S.g1, S.e, sw, true, S.xq, c0, lane);
    block_to_rows<true>(G + W::kDXK, acc, r0, c0, lane);
  }
  // (5) dG1 = -attn1^T @ dZb1c - db1_tot, (6) -= XK @ bf16(dW1) (the carry before this step's);
  // (8) de = rowsum(dG1 g1) (+ the dG2 g2 term in the row pass); dg1 = eta dG1;
  // (9) dP = dg1 gelu'(Z1) (over P in the workspace), dZ1 = dg1 P gelu''(Z1).
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    float acc[4][4] = {};
    ts::unit_mm_xyt<kF, NS>(acc, S.xk, S.xq, s, true, S.e, warp, lane);
    ts::slab_by_state<4, true>(acc, S.xk, s, gc.w1, lane);
    ts::fence_state(gc.w1);
    const float eta_lo = G[W::kETA + 16 * s + g], eta_hi = G[W::kETA + 16 * s + g + 8];
    float de_lo = 0.f, de_hi = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 dt1 = ts::b1_pair(G + W::kDB1T, warp, u, lane);
      float dg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[e] = acc[u][e] - ((e & 1) ? dt1.y : dt1.x);
      const float4 pp = *frag<NS>(G + W::kP, warp, s, u, lane), z = *frag<NS>(G + W::kZ1, warp, s, u, lane);
      const float zz[4] = {z.x, z.y, z.z, z.w}, pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float dp[4], dz[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float phi = tttb::gelu_bwd(zz[e]);
        const float g1 = pv[e] * phi;
        if (e < 2) de_lo += dg[e] * g1;
        else de_hi += dg[e] * g1;
        const float dg1 = (e < 2 ? eta_lo : eta_hi) * dg[e];
        dp[e] = dg1 * phi;
        dz[e] = dg1 * pv[e] * tttb::gelu_bwd2(zz[e]);
      }
      *frag<NS>(G + W::kP, warp, s, u, lane) = to4(dp);
      *frag<NS>(G + W::kDZ1, warp, s, u, lane) = to4(dz);
    }
    de_lo += __shfl_xor_sync(0xffffffffu, de_lo, 1);
    de_lo += __shfl_xor_sync(0xffffffffu, de_lo, 2);
    de_hi += __shfl_xor_sync(0xffffffffu, de_hi, 1);
    de_hi += __shfl_xor_sync(0xffffffffu, de_hi, 2);
    if (t == 0) {
      G[W::kPDE + warp * kCS + 16 * s + g] = de_lo;
      G[W::kPDE + warp * kCS + 16 * s + g + 8] = de_hi;
    }
  }
  // (5) dW1^T += dZb1c^T @ XQ.
  ts::rows_update<NS>(gc.w1, S.e, S.xq, warp, lane);
  sync();
  // dPc = bf16(dP) into the warp's columns.
#pragma unroll 1
  for (int s = 0; s < NS; ++s) {
    uint32_t x[4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = *frag<NS>(G + W::kP, warp, s, u, lane);
      x[u][0] = pack_bf16(v.x, v.y);
      x[u][1] = pack_bf16(v.z, v.w);
    }
    ts::store_slab(S.e, x, s, warp, lane);
  }
  sync();
  if (blk) {  // (9) dg2 += dPc @ W2 (eta dG2 added in the row pass); dW2 += dPc^T @ bf16(g2).
    float acc[4][4] = {};
    ts::block_mm<kF4, kF4, kF, false>(acc, S.e, r0, S.w2, c0, lane);
    block_to_rows<false>(G + W::kDPW, acc, r0, c0, lane);
  }
  ts::rows_update<NS>(gc.w2, S.e, S.g2c, warp, lane);
  sync();
  // Rows: (8) de, d_gate; (10) g2 = ln_fused_l2(Z2, target): dZ2, dtarget, dln; (12) the target LN:
  // dXV = dt, dXK -= dt, dln; colsum(dZ2) partials.
  {
    float2 cz = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int r = kR * warp; r < kR * warp + kR; ++r) {
      if constexpr (ts::kHalf<CS>) {
        if (r >= CS) {  // the padding: dZ2 0, no d_gate or dXV
          *reinterpret_cast<uint32_t*>(S.dzc + ts::swz<kF>(r, f0)) = 0u;
          continue;
        }
      }
      const float eta = G[W::kETA + r], sig = G[W::kSIG + r], sd = G[W::kSTD2 + r];
      const float2 xh = *reinterpret_cast<const float2*>(G + W::kZ2 + r * kF + f0);
      const float2 tg = *reinterpret_cast<const float2*>(G + W::kTGT + r * kF + f0);
      const float2 dG2 = *reinterpret_cast<const float2*>(G + W::kDG2 + r * kF + f0);
      const float2 g2r = *reinterpret_cast<const float2*>(G + W::kG2R + r * kF + f0);
      const float2 dpw = *reinterpret_cast<const float2*>(G + W::kDPW + r * kF + f0);
      const float de = warp_sum(dG2.x * g2r.x + dG2.y * g2r.y + (lane < kWarps ? G[W::kPDE + lane * kCS + r] : 0.f));
      if (lane == 0) A.dgate[(((size_t)b * A.a.H + h) * A.a.NC + n) * CS + r] = de * eta * (1.f - sig);
      const float u0 = eta * dG2.x + dpw.x, u1 = eta * dG2.y + dpw.y;
      const float y0 = lw.x * xh.x + lb.x, y1 = lw.y * xh.y + lb.y;
      const float gx0 = lw.x * (y0 - tg.x), gx1 = lw.y * (y1 - tg.y);
      const float mgx = warp_sum(gx0 + gx1) * (1.f / kF);
      const float m2 = warp_sum(gx0 * xh.x + gx1 * xh.y) * (1.f / kF);
      const float mean_u = warp_sum(u0 + u1) * (1.f / kF);
      const float mean_ux = warp_sum(u0 * xh.x + u1 * xh.y) * (1.f / kF);
      const float z0 = (gx0 - mgx - xh.x * m2) / sd, z1 = (gx1 - mgx - xh.y * m2) / sd;
      const float dgx0 = (u0 - mean_u - xh.x * mean_ux) / sd, dgx1 = (u1 - mean_u - xh.y * mean_ux) / sd;
      const float dxh0 = -(m2 * u0 + gx0 * mean_ux) / sd + lw.x * lw.x * dgx0;
      const float dxh1 = -(m2 * u1 + gx1 * mean_ux) / sd + lw.y * lw.y * dgx1;
      const float dstd = -warp_sum(u0 * z0 + u1 * z1) / sd;
      const float mdxh = warp_sum(dxh0 + dxh1) * (1.f / kF);
      const float mdxhx = warp_sum(dxh0 * xh.x + dxh1 * xh.y) * (1.f / kF);
      const float dz0 = (dxh0 - mdxh - xh.x * mdxhx) / sd + dstd * xh.x / kF;
      const float dz1 = (dxh1 - mdxh - xh.y * mdxhx) / sd + dstd * xh.y / kF;
      const float dt0 = -lw.x * dgx0, dt1 = -lw.y * dgx1;  // dtarget
      float2* lnw = reinterpret_cast<float2*>(G + W::kDLNW + r * kF + f0);
      float2* lnb = reinterpret_cast<float2*>(G + W::kDLNB + r * kF + f0);
      float2 w = *lnw, bb = *lnb;
      w.x += dgx0 * (y0 - tg.x) + dgx0 * lw.x * xh.x;
      w.y += dgx1 * (y1 - tg.y) + dgx1 * lw.y * xh.y;
      bb.x += dgx0 * lw.x;
      bb.y += dgx1 * lw.y;
      *reinterpret_cast<uint32_t*>(S.dzc + ts::swz<kF>(r, f0)) = pack_bf16(dz0, dz1);
      cz.x += dz0;
      cz.y += dz1;
      // (12) target = LN-reconstruction(XV - XK).
      const float st = G[W::kST + r];
      const float sqrtv = fmaxf(st - 1e-8f, 1e-20f);
      const float2 th = *reinterpret_cast<const float2*>(G + W::kTHAT + r * kF + f0);
      const float gg0 = lw.x * dt0, gg1 = lw.y * dt1;
      const float mg = warp_sum(gg0 + gg1) * (1.f / kF);
      const float sgt = warp_sum(gg0 * th.x + gg1 * th.y);
      const float v0 = (gg0 - mg) / st - th.x * (sgt / ((kF - 1) * sqrtv));
      const float v1 = (gg1 - mg) / st - th.y * (sgt / ((kF - 1) * sqrtv));
      w.x += dt0 * th.x;
      w.y += dt1 * th.y;
      bb.x += dt0;
      bb.y += dt1;
      *lnw = w;
      *lnb = bb;
      float2* dxk = reinterpret_cast<float2*>(G + W::kDXK + r * kF + f0);
      *dxk = make_float2(dxk->x - v0, dxk->y - v1);
      *reinterpret_cast<__nv_bfloat162*>(A.dxv + x_offset<CS>(A.a, b, h, n, r, f0)) = __floats2bfloat162_rn(v0, v1);
    }
    *reinterpret_cast<float2*>(G + W::kPZ2 + warp * kF + f0) = cz;
  }
  sync();
  // (11) dX2 += dZ2c @ W2^T; (13) dZ1 += gelu'(Z1) dX2, dZ1c into the warp's columns; db1 = db1_tot + colsum(dZ1).
  {
    float cs[4][2] = {};
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = *frag<NS>(G + W::kDX2, warp, s, u, lane);
        acc[u][0] = v.x, acc[u][1] = v.y, acc[u][2] = v.z, acc[u][3] = v.w;
      }
      ts::unit_mm_w(acc, S.dzc, s, S.w2, warp, lane);
      uint32_t dz[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 z = *frag<NS>(G + W::kZ1, warp, s, u, lane), d = *frag<NS>(G + W::kDZ1, warp, s, u, lane);
        const float e0 = d.x + tttb::gelu_bwd(z.x) * acc[u][0], e1 = d.y + tttb::gelu_bwd(z.y) * acc[u][1];
        const float e2 = d.z + tttb::gelu_bwd(z.z) * acc[u][2], e3 = d.w + tttb::gelu_bwd(z.w) * acc[u][3];
        cs[u][0] += e0 + e2;
        cs[u][1] += e1 + e3;
        dz[u][0] = pack_bf16(e0, e1);
        dz[u][1] = pack_bf16(e2, e3);
      }
      ts::store_slab(S.e, dz, s, warp, lane);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // db1 = db1_tot + colsum(dZ1)
      const float c0s = reduce_g(cs[u][0]), c1s = reduce_g(cs[u][1]);
      const float2 d = ts::b1_pair(G + W::kDB1T, warp, u, lane);
      if (g == 0)
        *reinterpret_cast<float2*>(G + W::kDB1 + 32 * warp + 8 * u + 2 * t) = make_float2(d.x + c0s, d.y + c1s);
    }
  }
  // (11) dW2 += X2c^T @ dZ2c; db2 = db2_tot + colsum(dZ2).
  ts::rows_update<NS>(gc.w2, S.x2c, S.dzc, warp, lane);
  if (warp == 0) {
    float2 d = *reinterpret_cast<const float2*>(G + W::kDB2 + f0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(G + W::kPZB2 + w * kF + f0);
      const float2 z = *reinterpret_cast<const float2*>(G + W::kPZ2 + w * kF + f0);
      d.x += v.x + z.x;
      d.y += v.y + z.y;
    }
    *reinterpret_cast<float2*>(G + W::kDB2 + f0) = d;
  }
  sync();
  if (blk) {  // (14) dXK += dZ1c @ W1^T; dW1^T += dZ1c^T @ XK.
    float acc[4][4] = {};
    ts::block_mm<kF4, kF4, kF, false>(acc, S.e, r0, S.w1t, c0, lane);
    block_to_rows<true>(G + W::kDXK, acc, r0, c0, lane);
  }
  ts::rows_update<NS>(gc.w1, S.e, S.xk, warp, lane);
  sync();
  // (15) rope, then the L2 norm, back to the raw projections.
#pragma unroll 1
  for (int r = kR * warp; r < kR * warp + kR; ++r) {
    if constexpr (ts::kHalf<CS>) {
      if (r >= CS) break;
    }
    const size_t xo = x_offset<CS>(A.a, b, h, n, r, f0);
    const size_t to = ((size_t)n * CS + r) * kF + f0;
    const float2 c = *reinterpret_cast<const float2*>(A.a.cos + to);
    const float2 sn = *reinterpret_cast<const float2*>(A.a.sin + to);
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float2 dv = *reinterpret_cast<const float2*>(G + (which == 0 ? W::kDXQ : W::kDXK) + r * kF + f0);
      const float r0v = dv.x * c.x + dv.y * sn.x, r1v = dv.y * c.y - dv.x * sn.y;  // u*cos - pair_swap(u)*sin
      const __nv_bfloat16* raw = which == 0 ? A.a.xq : A.a.xk;
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw + xo));
      const float nrm = sqrtf(warp_sum(x.x * x.x + x.y * x.y));
      const float m = fmaxf(nrm, 1e-12f);
      const float proj = warp_sum(r0v * x.x + r1v * x.y);
      const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
      __nv_bfloat16* dst = which == 0 ? A.dxq : A.dxk;
      *reinterpret_cast<__nv_bfloat162*>(dst + xo) = __floats2bfloat162_rn(r0v / m - x.x * corr, r1v / m - x.y * corr);
    }
  }
}

template <int CS>
__global__ void __launch_bounds__(kThreads, 1) ttt_mlp_bwd_kernel(const BwdArgs A) {
  constexpr int NS = ts::slabs(CS), kCS = ts::kSlab * NS, kR = 2 * NS;  // kCS: the tiles' rows
  using W = Work<NS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NS>& S = *reinterpret_cast<Smem<NS>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC, K = A.K;
  const int NG = (NC + K - 1) / K;
  float* G = reinterpret_cast<float*>(A.work + (size_t)bh * A.work_bytes);
  float* B1S = G + W::kB1S;
  float* B2S = B1S + (size_t)K * kF4;
  bf16* W1S = reinterpret_cast<bf16*>(B2S + (size_t)K * kF);
  bf16* W2S = W1S + (size_t)K * kState;
  const float* lnw_h = A.ln_w + (size_t)h * kF;
  const float* lnb_h = A.ln_b + (size_t)h * kF;

  ts::State gc;  // the carries: w1 = dW1^T, w2 = dW2 (db1 and db2 live in the workspace)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) gc.w1[m][f][e] = gc.w2[m][f][e] = 0.f;
  for (int c = threadIdx.x; c < kF4; c += kThreads) G[W::kDB1 + c] = 0.f;
  for (int r = kR * warp; r < kR * warp + kR; ++r) {
    *reinterpret_cast<float2*>(G + W::kDLNW + r * kF + 2 * lane) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(G + W::kDLNB + r * kF + 2 * lane) = make_float2(0.f, 0.f);
  }
  if (warp == 0) *reinterpret_cast<float2*>(G + W::kDB2 + 2 * lane) = make_float2(0.f, 0.f);

  const ts::Tiles T{S.x2c, nullptr, S.w2, reinterpret_cast<float*>(S.e), S.g2c, S.g2, S.g1, S.b1};
  for (int grp = NG - 1; grp >= 0; --grp) {
    const int n0 = grp * K, valid = min(K, NC - n0);
    // Pass A: the forward from checkpoint grp, stashing each step's state; the carries wait in the workspace.
    park(G + W::kPark, gc, tid);
    {
      const size_t ck = (size_t)bh * NG + grp;
      ts::State st;
      sync();  // the previous pass is done with the tiles
      ts::load_state(st, A.w1_ck + ck * kState, A.b1_ck + ck * kF4, A.w2_ck + ck * kState, A.b2_ck + ck * kF, S.w2,
                     S.b1, warp, lane);
      for (int i = 0; i < valid; ++i) {
        ts::stash_state(st, W1S + (size_t)i * kState, W2S + (size_t)i * kState, warp, lane);
        if ((lane >> 2) == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            *reinterpret_cast<float2*>(B1S + (size_t)i * kF4 + 32 * warp + 8 * u + 2 * (lane & 3)) =
                ts::b1_pair(S.b1, warp, u, lane);
        }
        if (warp == 0) *reinterpret_cast<float2*>(B2S + (size_t)i * kF + 2 * lane) = st.b2;
        sync();  // the previous step is done with the prepared tiles
        const ts::Prep p{S.xq, S.xk, G + W::kTGT, G + W::kETA, nullptr, nullptr, nullptr};
        ts::prepare_rows<CS, kR>(p, A.a, A.ln_w, A.ln_b, b, h, n0 + i, warp, lane);
        sync();
        ts::forward_step<CS, false>(st, p, T, lnw_h, lnb_h, nullptr, 0, 0, warp, lane);
      }
    }
    unpark(gc, G + W::kPark, tid);
    // Pass B: the step VJP, last step first.
    for (int i = valid - 1; i >= 0; --i) backward_step<CS>(S, G, A, b, h, n0 + i, i, gc, warp, lane);
  }

  gc.b2 = *reinterpret_cast<const float2*>(G + W::kDB2 + 2 * lane);
  sync();  // db1 complete
  ts::save_state(gc, G + W::kDB1, A.dW1 + (size_t)bh * kState, A.db1 + (size_t)bh * kF4, A.dW2 + (size_t)bh * kState,
                 A.db2 + (size_t)bh * kF, warp, lane);
  sync();
  if (tid < kF) {
    float sw = 0.f, sb = 0.f;
    for (int r = 0; r < kCS; ++r) {
      sw += G[W::kDLNW + r * kF + tid];
      sb += G[W::kDLNB + r * kF + tid];
    }
    A.dlnw[(size_t)bh * kF + tid] = sw;
    A.dlnb[(size_t)bh * kF + tid] = sb;
  }
}

}  // namespace

// Bytes of K2's workspace a (batch, head) at mini-batch cs and checkpoint group K (negative for a CS it does not
// take).
extern "C" long long ttt_mlp_backward_workspace_bytes(int cs, int K) {
  long long bytes = -1;
  ts::with_slabs(cs, [&](auto c) { return (int)((bytes = workspace_bytes<ts::slabs(decltype(c)::value)>(K)) > 0); });
  return bytes;
}

// Shared memory of the instantiation for mini-batch cs (an error code, negative, for a CS it is not built for).
extern "C" int ttt_mlp_backward_smem_bytes(int cs) {
  int bytes = -static_cast<int>(cudaErrorInvalidValue);
  ts::with_slabs(cs, [&](auto c) { return bytes = (int)sizeof(Smem<ts::slabs(decltype(c)::value)>); });
  return bytes;
}

extern "C" int ttt_mlp_backward(const void* xq, const void* xk, const void* xv, const void* gate, const void* rope_cos,
                                const void* rope_sin, const void* ln_w, const void* ln_b, const void* w1_ck,
                                const void* b1_ck, const void* w2_ck, const void* b2_ck, const void* dout, void* dxq,
                                void* dxk, void* dxv, void* dgate, void* dW1, void* db1, void* dW2, void* db2,
                                void* dlnw, void* dlnb, void* work, int B, int NC, int H, int CS, int K,
                                float eta_scale, void* stream) {
  BwdArgs A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                   static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                   static_cast<const float*>(rope_sin), NC, H, eta_scale},
                  static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(w1_ck),
                  static_cast<const float*>(b1_ck), static_cast<const float*>(w2_ck), static_cast<const float*>(b2_ck),
                  static_cast<const bf16*>(dout), static_cast<bf16*>(dxq), static_cast<bf16*>(dxk),
                  static_cast<bf16*>(dxv), static_cast<float*>(dgate), static_cast<float*>(dW1),
                  static_cast<float*>(db1), static_cast<float*>(dW2), static_cast<float*>(db2),
                  static_cast<float*>(dlnw), static_cast<float*>(dlnb), static_cast<unsigned char*>(work), 0, K};
  return ts::with_slabs(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value, NS = ts::slabs(kMiniBatch);
    constexpr int kBytes = sizeof(Smem<NS>);
    cudaError_t err =
        cudaFuncSetAttribute(ttt_mlp_bwd_kernel<kMiniBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    A.work_bytes = workspace_bytes<NS>(K);
    ttt_mlp_bwd_kernel<kMiniBatch><<<B * H, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
