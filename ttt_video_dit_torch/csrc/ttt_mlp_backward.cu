// Fused TTT-MLP backward (K2), head_dim F = 64, mini-batch CS = 64, for
// Hopper (sm_90a).
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
// inside one SM (about 40 small matrix products per step, ~50 MFLOP).
//
// Design: one block of 256 threads per (batch, head). The fp32 state
// (128 KiB) and the fp32 gradient carries dW1/dW2 (128 KiB) do not both fit
// one SM's 227 KB, so both live in device memory: the carries in the dW1/dW2
// outputs themselves, the pass-A state and every per-step tile in a
// per-block workspace that the wrapper allocates (~2.5 MiB at K = 16), and
// the pass-A stash of K steps x (W1 + W2) in bf16 (1 MiB at K = 16; stashing
// in bf16 is exact, pass B uses W only rounded). The bias and LN carries are
// shared-memory vectors. Every product goes through ttt_mlp_block.cuh's
// mm() with its operands rounded to bf16 where the Pallas kernel calls
// .astype(dt) (l.235-399). The LN-parameter cotangents are kept per
// element of a [CS][F] tile over the whole scan and reduced over rows once
// at the end. The ln and bias gradients come out compact ([F], [4F]) per
// (batch, head); the wrapper sums them over the batch.
// Not yet done (later work): tensor cores, on-chip tiles, a split of one
// scan across a thread-block cluster.
//
// Layouts: as ttt_mlp_forward.cu; dout/dxq/dxk/dxv [B, NC, CS, H*F] bf16;
// dgate [B, H, NC, CS] f32; checkpoints W1 [B, H, NG, F, 4F], b1
// [B, H, NG, 1, 4F], W2 [B, H, NG, 4F, F], b2 [B, H, NG, 1, F] f32; outputs
// dW1 [B, H, F, 4F], db1 [B, H, 1, 4F], dW2 [B, H, 4F, F], db2 [B, H, 1, F],
// dln_w/dln_b [B, H, F] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ttt_mlp_block.cuh"

namespace {

using tttb::bf16r;
using tttb::kCS;
using tttb::kF;
using tttb::kF4;
using tttb::kState;
using tttb::kThreads;
using tttb::kTile;
using tttb::kWide;
using tttb::mm;
using tttb::warp_sum;

// Per-(batch, head) fp32 workspace, in floats.
enum : int {
  kW1 = 0, kW2 = kW1 + kState,
  // [CS][F] tiles
  kXQ = kW2 + kState, kXK = kXQ + kTile, kTG = kXK + kTile, kTHAT = kTG + kTile, kZ2H = kTHAT + kTile,
  kG2R = kZ2H + kTile, kG2 = kG2R + kTile, kGZ2 = kG2 + kTile, kA1 = kGZ2 + kTile, kA2 = kA1 + kTile,
  kZB2H = kA2 + kTile, kDZB2 = kZB2H + kTile, kDA2 = kDZB2 + kTile, kDG2 = kDA2 + kTile, kDXQ = kDG2 + kTile,
  kDXK = kDXQ + kTile, kDA1 = kDXK + kTile, kDZ2 = kDA1 + kTile, kDTGT = kDZ2 + kTile, kDLNW = kDTGT + kTile,
  kDLNB = kDLNW + kTile,
  // [CS][4F] tiles
  kZ1 = kDLNB + kTile, kPHI = kZ1 + kWide, kX2C = kPHI + kWide, kP = kX2C + kWide, kG1R = kP + kWide,
  kG1 = kG1R + kWide, kZB1 = kG1 + kWide, kXB2C = kZB1 + kWide, kDXB2 = kXB2C + kWide, kDX2 = kDXB2 + kWide,
  kDZB1 = kDX2 + kWide, kDG1 = kDZB1 + kWide, kDZ1 = kDG1 + kWide,
  // this step's contributions to dW1 [F][4F] and dW2 [4F][F]
  kDW1S = kDZ1 + kWide, kDW2S = kDW1S + kState,
  kWorkFloats = kDW2S + kState,
};

// Shared-memory vectors of the backward beyond tttb::Vecs.
struct BwdVecs {
  float db1[kF4], db2[kF];    // bias cotangent carries
  float db1t[kF4], db2t[kF];  // db_tot = carry + colsum(dZb)
  float std2[kCS], stdb2[kCS], st[kCS], de[kCS];
};

__device__ __forceinline__ size_t x_offset(const tttb::ScanArgs& a, int b, int h, int n, int r, int f) {
  return (((size_t)b * a.NC + n) * kCS + r) * ((size_t)a.H * kF) + (size_t)h * kF + f;
}

// One step of pass B: recompute the step's forward intermediates from the
// stashed state (W1s/W2s bf16, v.b1/v.b2), then apply the step VJP.
__device__ void backward_step(const tttb::ScanArgs& a, int b, int h, int n, tttb::Vecs& v, BwdVecs& s, float* w,
                              const __nv_bfloat16* W1s, const __nv_bfloat16* W2s,
                              const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dxq,
                              __nv_bfloat16* __restrict__ dxk, __nv_bfloat16* __restrict__ dxv,
                              float* __restrict__ dgate, float* dW1c, float* dW2c, float* stage) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = 2 * lane;
  float *XQ = w + kXQ, *XK = w + kXK, *TG = w + kTG, *THAT = w + kTHAT, *Z2H = w + kZ2H, *G2R = w + kG2R;
  float *G2 = w + kG2, *A1 = w + kA1, *A2 = w + kA2, *ZB2H = w + kZB2H, *DZB2 = w + kDZB2, *DA2 = w + kDA2;
  float *DG2 = w + kDG2, *DXQ = w + kDXQ, *DXK = w + kDXK, *DA1 = w + kDA1, *DZ2 = w + kDZ2, *DTGT = w + kDTGT;
  float *DLNW = w + kDLNW, *DLNB = w + kDLNB;
  float *Z1 = w + kZ1, *PHI = w + kPHI, *X2C = w + kX2C, *P = w + kP, *G1R = w + kG1R, *G1 = w + kG1;
  float *ZB1 = w + kZB1, *XB2C = w + kXB2C, *DXB2 = w + kDXB2, *DX2 = w + kDX2, *DZB1 = w + kDZB1;
  float *DG1 = w + kDG1, *DZ1 = w + kDZ1, *DW1S = w + kDW1S, *DW2S = w + kDW2S;
  const float* lnw = v.lnw;
  const float* lnb = v.lnb;

  // ---- Recompute the forward intermediates.
  tttb::preprocess(a, b, h, n, v, XQ, XK, TG, THAT, s.st);
  // Z1 = XK @ W1 + b1; phi = gelu'(Z1); X2c = bf16(gelu(Z1)).
  mm(kCS, kF4, kF, XK, kF, 1, false, W1s, kF4, 1, false, Z1, kF4, 1.f, false, stage);
  for (int i = tid; i < kWide; i += kThreads) {
    const float z = Z1[i] + v.b1[i & (kF4 - 1)];
    Z1[i] = z;
    PHI[i] = tttb::gelu_bwd(z);
    X2C[i] = bf16r(tttb::gelu_tanh(z));
  }
  __syncthreads();
  // Z2 = X2c @ W2 + b2 -> (z2_hat, std2); g2 = ln_fused_l2(Z2, target); G2 = bf16(eta g2).
  mm(kCS, kF, kF4, X2C, kF4, 1, false, W2s, kF, 1, false, Z2H, kF, 1.f, false, stage);
  for (int r = warp; r < kCS; r += 8) {
    float x[2], xh[2], gx[2];
    for (int e = 0; e < 2; ++e) x[e] = Z2H[r * kF + f0 + e] + v.b2[f0 + e];
    const float mu = warp_sum(x[0] + x[1]) * (1.f / kF);
    const float sd = sqrtf(warp_sum((x[0] - mu) * (x[0] - mu) + (x[1] - mu) * (x[1] - mu)) * (1.f / kF) + 1e-8f);
    for (int e = 0; e < 2; ++e) {
      const int f = f0 + e;
      xh[e] = (x[e] - mu) / sd;
      gx[e] = lnw[f] * (lnw[f] * xh[e] + lnb[f] - TG[r * kF + f]);
    }
    const float mg = warp_sum(gx[0] + gx[1]) * (1.f / kF);
    const float m2 = warp_sum(gx[0] * xh[0] + gx[1] * xh[1]) * (1.f / kF);
    for (int e = 0; e < 2; ++e) {
      const float g = (gx[e] - mg - xh[e] * m2) / sd;
      Z2H[r * kF + f0 + e] = xh[e];
      G2R[r * kF + f0 + e] = g;
      G2[r * kF + f0 + e] = bf16r(v.eta[r] * g);
    }
    if (lane == 0) s.std2[r] = sd;
  }
  __syncthreads();
  // P = bf16(g2) @ W2^T; g1 = P * phi; G1 = bf16(eta g1).
  mm(kCS, kF4, kF, G2R, kF, 1, true, W2s, 1, kF, false, P, kF4, 1.f, false, stage);
  for (int i = tid; i < kWide; i += kThreads) {
    const float g1 = P[i] * PHI[i];
    G1R[i] = g1;
    G1[i] = bf16r(v.eta[i / kF4] * g1);
  }
  __syncthreads();
  // A1 = bf16(XQ @ XK^T).
  mm(kCS, kCS, kF, XQ, kF, 1, false, XK, 1, kF, false, A1, kCS, 1.f, false, stage);
  for (int i = tid; i < kTile; i += kThreads) A1[i] = bf16r(A1[i]);
  __syncthreads();
  // Zb1 = XQ @ W1 - A1 @ G1 + b1 - colsum(G1); Xb2c = bf16(gelu(Zb1)).
  tttb::colsum(G1, kF4, v.cs);
  mm(kCS, kF4, kF, XQ, kF, 1, false, W1s, kF4, 1, false, ZB1, kF4, 1.f, false, stage);
  mm(kCS, kF4, kCS, A1, kCS, 1, false, G1, kF4, 1, false, ZB1, kF4, -1.f, true, stage);
  for (int i = tid; i < kWide; i += kThreads) {
    const int c = i & (kF4 - 1);
    const float z = (ZB1[i] + v.b1[c]) - v.cs[c];
    ZB1[i] = z;
    XB2C[i] = bf16r(tttb::gelu_tanh(z));
  }
  __syncthreads();
  // A2 = bf16(Xb2c @ X2c^T).
  mm(kCS, kCS, kF4, XB2C, kF4, 1, false, X2C, 1, kF4, false, A2, kCS, 1.f, false, stage);
  for (int i = tid; i < kTile; i += kThreads) A2[i] = bf16r(A2[i]);
  __syncthreads();
  // Zb2 = Xb2c @ W2 - A2 @ G2 + b2 - colsum(G2) -> (zb2_hat, stdb2).
  tttb::colsum(G2, kF, v.cs);
  mm(kCS, kF, kF4, XB2C, kF4, 1, false, W2s, kF, 1, false, ZB2H, kF, 1.f, false, stage);
  mm(kCS, kF, kCS, A2, kCS, 1, false, G2, kF, 1, false, ZB2H, kF, -1.f, true, stage);
  for (int r = warp; r < kCS; r += 8) {
    float x[2];
    for (int e = 0; e < 2; ++e) x[e] = (ZB2H[r * kF + f0 + e] + v.b2[f0 + e]) - v.cs[f0 + e];
    const float mu = warp_sum(x[0] + x[1]) * (1.f / kF);
    const float sd = sqrtf(warp_sum((x[0] - mu) * (x[0] - mu) + (x[1] - mu) * (x[1] - mu)) * (1.f / kF) + 1e-8f);
    for (int e = 0; e < 2; ++e) ZB2H[r * kF + f0 + e] = (x[e] - mu) / sd;
    if (lane == 0) s.stdb2[r] = sd;
  }
  __syncthreads();

  // ---- (1) out = XQ + LN(Zb2): dZb2 = ln_fwd_vjp; dXQ = d_out.
  for (int r = warp; r < kCS; r += 8) {
    const float2 u2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + x_offset(a, b, h, n, r, f0)));
    const float u[2] = {u2.x, u2.y};
    float xh[2], wv[2];
    for (int e = 0; e < 2; ++e) {
      xh[e] = ZB2H[r * kF + f0 + e];
      wv[e] = lnw[f0 + e] * u[e];
    }
    const float mw = warp_sum(wv[0] + wv[1]) * (1.f / kF);
    const float mwx = warp_sum(wv[0] * xh[0] + wv[1] * xh[1]) * (1.f / kF);
    for (int e = 0; e < 2; ++e) {
      const int i = r * kF + f0 + e;
      DZB2[i] = (wv[e] - mw - xh[e] * mwx) / s.stdb2[r];
      DLNW[i] += u[e] * xh[e];
      DLNB[i] += u[e];
      DXQ[i] = u[e];
    }
  }
  __syncthreads();
  // (2) Zb2 = Xb2 @ W2 - A2 @ G2 + b2'.
  mm(kCS, kF4, kF, DZB2, kF, 1, true, W2s, 1, kF, false, DXB2, kF4, 1.f, false, stage);
  mm(kF4, kF, kCS, XB2C, 1, kF4, false, DZB2, kF, 1, true, DW2S, kF, 1.f, false, stage);
  mm(kCS, kCS, kF, DZB2, kF, 1, true, G2, 1, kF, false, DA2, kCS, -1.f, false, stage);
  tttb::colsum(DZB2, kF, v.cs);
  if (tid < kF) s.db2t[tid] = s.db2[tid] + v.cs[tid];
  mm(kCS, kF, kCS, A2, 1, kCS, false, DZB2, kF, 1, true, DG2, kF, -1.f, false, stage);
  for (int i = tid; i < kTile; i += kThreads) DG2[i] -= s.db2t[i & (kF - 1)];
  __syncthreads();
  // (3) A2 = Xb2 @ X2^T.
  mm(kCS, kF4, kCS, DA2, kCS, 1, true, X2C, kF4, 1, false, DXB2, kF4, 1.f, true, stage);
  mm(kCS, kF4, kCS, DA2, 1, kCS, true, XB2C, kF4, 1, false, DX2, kF4, 1.f, false, stage);
  // (4) Xb2 = gelu(Zb1).
  for (int i = tid; i < kWide; i += kThreads) DZB1[i] = tttb::gelu_bwd(ZB1[i]) * DXB2[i];
  __syncthreads();
  // (5) Zb1 = XQ @ W1 - A1 @ G1 + b1'.
  mm(kCS, kF, kF4, DZB1, kF4, 1, true, W1s, 1, kF4, false, DXQ, kF, 1.f, true, stage);
  mm(kF, kF4, kCS, XQ, 1, kF, false, DZB1, kF4, 1, true, DW1S, kF4, 1.f, false, stage);
  mm(kCS, kCS, kF4, DZB1, kF4, 1, true, G1, 1, kF4, false, DA1, kCS, -1.f, false, stage);
  tttb::colsum(DZB1, kF4, v.cs);
  s.db1t[tid] = s.db1[tid] + v.cs[tid];
  mm(kCS, kF4, kCS, A1, 1, kCS, false, DZB1, kF4, 1, true, DG1, kF4, -1.f, false, stage);
  for (int i = tid; i < kWide; i += kThreads) DG1[i] -= s.db1t[i & (kF4 - 1)];
  __syncthreads();
  // (6) the state updates W' = W - X^T G, through the carries dW1c/dW2c (before this step's update).
  mm(kCS, kF4, kF, G2, kF, 1, false, dW2c, 1, kF, true, DX2, kF4, -1.f, true, stage);
  mm(kCS, kF, kF4, X2C, kF4, 1, false, dW2c, kF, 1, true, DG2, kF, -1.f, true, stage);
  mm(kCS, kF, kF4, G1, kF4, 1, false, dW1c, 1, kF4, true, DXK, kF, -1.f, false, stage);
  mm(kCS, kF4, kF, XK, kF, 1, false, dW1c, kF4, 1, true, DG1, kF4, -1.f, true, stage);
  // (7) A1 = XQ @ XK^T.
  mm(kCS, kF, kCS, DA1, kCS, 1, true, XK, kF, 1, false, DXQ, kF, 1.f, true, stage);
  mm(kCS, kF, kCS, DA1, 1, kCS, true, XQ, kF, 1, false, DXK, kF, 1.f, true, stage);
  // (8) G = eta * g: de = rowsum(dG2 g2) + rowsum(dG1 g1); dg = eta dG (in place).
  for (int r = warp; r < kCS; r += 8) {
    float sum = 0.f;
    for (int e = 0; e < 2; ++e) sum += DG2[r * kF + f0 + e] * G2R[r * kF + f0 + e];
    for (int c = lane; c < kF4; c += 32) sum += DG1[r * kF4 + c] * G1R[r * kF4 + c];
    sum = warp_sum(sum);
    const float eta = v.eta[r];
    for (int e = 0; e < 2; ++e) DG2[r * kF + f0 + e] *= eta;
    for (int c = lane; c < kF4; c += 32) DG1[r * kF4 + c] *= eta;
    if (lane == 0) s.de[r] = sum;
  }
  __syncthreads();
  // (9) g1 = (g2 @ W2^T) * gelu'(Z1): dZ1 = dg1 P gelu''(Z1); dP = dg1 phi (into P).
  for (int i = tid; i < kWide; i += kThreads) {
    const float dg1 = DG1[i];
    DZ1[i] = dg1 * P[i] * tttb::gelu_bwd2(Z1[i]);
    P[i] = dg1 * PHI[i];
  }
  __syncthreads();
  mm(kCS, kF, kF4, P, kF4, 1, true, W2s, kF, 1, false, DG2, kF, 1.f, true, stage);
  mm(kF4, kF, kCS, P, 1, kF4, true, G2R, kF, 1, true, DW2S, kF, 1.f, true, stage);
  // (10) g2 = ln_fused_l2(Z2, target): the second-order LN term.
  for (int r = warp; r < kCS; r += 8) {
    const float sd = s.std2[r];
    float xh[2], y[2], gx[2], u[2];
    for (int e = 0; e < 2; ++e) {
      const int i = r * kF + f0 + e, f = f0 + e;
      xh[e] = Z2H[i];
      u[e] = DG2[i];
      y[e] = lnw[f] * xh[e] + lnb[f];
      gx[e] = lnw[f] * (y[e] - TG[i]);
    }
    const float mgx = warp_sum(gx[0] + gx[1]) * (1.f / kF);
    const float m2 = warp_sum(gx[0] * xh[0] + gx[1] * xh[1]) * (1.f / kF);
    const float mean_u = warp_sum(u[0] + u[1]) * (1.f / kF);
    const float mean_ux = warp_sum(u[0] * xh[0] + u[1] * xh[1]) * (1.f / kF);
    float z[2], dgx[2], dxh[2];
    for (int e = 0; e < 2; ++e) {
      const int f = f0 + e;
      z[e] = (gx[e] - mgx - xh[e] * m2) / sd;
      dgx[e] = (u[e] - mean_u - xh[e] * mean_ux) / sd;
      dxh[e] = -(m2 * u[e] + gx[e] * mean_ux) / sd + lnw[f] * lnw[f] * dgx[e];
    }
    const float dstd = -warp_sum(u[0] * z[0] + u[1] * z[1]) / sd;
    const float mdxh = warp_sum(dxh[0] + dxh[1]) * (1.f / kF);
    const float mdxhx = warp_sum(dxh[0] * xh[0] + dxh[1] * xh[1]) * (1.f / kF);
    for (int e = 0; e < 2; ++e) {
      const int i = r * kF + f0 + e, f = f0 + e;
      DZ2[i] = (dxh[e] - mdxh - xh[e] * mdxhx) / sd + dstd * xh[e] / kF;
      DTGT[i] = -lnw[f] * dgx[e];
      DLNW[i] += dgx[e] * (y[e] - TG[i]) + dgx[e] * lnw[f] * xh[e];
      DLNB[i] += dgx[e] * lnw[f];
    }
  }
  __syncthreads();
  // (11) Z2 = X2 @ W2 + b2.
  mm(kCS, kF4, kF, DZ2, kF, 1, true, W2s, 1, kF, false, DX2, kF4, 1.f, true, stage);
  mm(kF4, kF, kCS, X2C, 1, kF4, false, DZ2, kF, 1, true, DW2S, kF, 1.f, true, stage);
  tttb::colsum(DZ2, kF, v.cs);
  if (tid < kF) s.db2[tid] = s.db2t[tid] + v.cs[tid];
  // (12) target = LN-reconstruction(XV - XK): dXV = dt, dXK -= dt.
  for (int r = warp; r < kCS; r += 8) {
    const float st = s.st[r];
    const float sqrtv = fmaxf(st - 1e-8f, 1e-20f);
    float th[2], u[2], g[2];
    for (int e = 0; e < 2; ++e) {
      const int i = r * kF + f0 + e;
      th[e] = THAT[i];
      u[e] = DTGT[i];
      g[e] = lnw[f0 + e] * u[e];
    }
    const float mg = warp_sum(g[0] + g[1]) * (1.f / kF);
    const float sgt = warp_sum(g[0] * th[0] + g[1] * th[1]);
    float dt[2];
    for (int e = 0; e < 2; ++e) {
      const int i = r * kF + f0 + e;
      dt[e] = (g[e] - mg) / st - th[e] * (sgt / ((kF - 1) * sqrtv));
      DLNW[i] += u[e] * th[e];
      DLNB[i] += u[e];
      DXK[i] -= dt[e];
    }
    *reinterpret_cast<__nv_bfloat162*>(dxv + x_offset(a, b, h, n, r, f0)) = __floats2bfloat162_rn(dt[0], dt[1]);
  }
  __syncthreads();
  // (13) X2 = gelu(Z1).
  for (int i = tid; i < kWide; i += kThreads) DZ1[i] += PHI[i] * DX2[i];
  __syncthreads();
  // (14) Z1 = XK @ W1 + b1.
  mm(kCS, kF, kF4, DZ1, kF4, 1, true, W1s, 1, kF4, false, DXK, kF, 1.f, true, stage);
  mm(kF, kF4, kCS, XK, 1, kF, false, DZ1, kF4, 1, true, DW1S, kF4, 1.f, true, stage);
  tttb::colsum(DZ1, kF4, v.cs);
  s.db1[tid] = s.db1t[tid] + v.cs[tid];
  // (15) rope, then the L2 norm, back to the raw projections; d_gate.
  for (int r = warp; r < kCS; r += 8) {
    const size_t xo = x_offset(a, b, h, n, r, f0);
    const size_t to = ((size_t)n * kCS + r) * kF + f0;
    const float2 c = *reinterpret_cast<const float2*>(a.cos + to);
    const float2 sn = *reinterpret_cast<const float2*>(a.sin + to);
    for (int which = 0; which < 2; ++which) {
      const float* D = which == 0 ? DXQ : DXK;
      const __nv_bfloat16* raw = which == 0 ? a.xq : a.xk;
      const float u0 = D[r * kF + f0], u1 = D[r * kF + f0 + 1];
      const float r0 = u0 * c.x + u1 * sn.x, r1 = u1 * c.y - u0 * sn.y;  // u*cos - pair_swap(u)*sin
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(raw + xo));
      const float nrm = sqrtf(warp_sum(x.x * x.x + x.y * x.y));
      const float m = fmaxf(nrm, 1e-12f);
      const float proj = warp_sum(r0 * x.x + r1 * x.y);
      const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
      __nv_bfloat16* dst = which == 0 ? dxq : dxk;
      *reinterpret_cast<__nv_bfloat162*>(dst + xo) = __floats2bfloat162_rn(r0 / m - x.x * corr, r1 / m - x.y * corr);
    }
    if (lane == 0) dgate[(((size_t)b * a.H + h) * a.NC + n) * kCS + r] = s.de[r] * v.eta[r] * (1.f - v.sig[r]);
  }
  // The carries: dW += this step's contributions.
  for (int i = tid; i < kState; i += kThreads) {
    dW1c[i] += DW1S[i];
    dW2c[i] += DW2S[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
ttt_mlp_bwd_kernel(tttb::ScanArgs a, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   const float* __restrict__ w1_ck, const float* __restrict__ b1_ck, const float* __restrict__ w2_ck,
                   const float* __restrict__ b2_ck, const __nv_bfloat16* __restrict__ dout,
                   __nv_bfloat16* __restrict__ dxq, __nv_bfloat16* __restrict__ dxk, __nv_bfloat16* __restrict__ dxv,
                   float* __restrict__ dgate, float* __restrict__ dW1, float* __restrict__ db1,
                   float* __restrict__ dW2, float* __restrict__ db2, float* __restrict__ dlnw,
                   float* __restrict__ dlnb, unsigned char* __restrict__ work, long long work_bytes, int K) {
  __shared__ __align__(16) float stage[tttb::kStageFloats];
  __shared__ tttb::Vecs v;
  __shared__ BwdVecs s;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int NG = (a.NC + K - 1) / K;
  float* w = reinterpret_cast<float*>(work + (size_t)bh * work_bytes);
  __nv_bfloat16* W1S = reinterpret_cast<__nv_bfloat16*>(w + kWorkFloats);  // [K][F][4F]
  __nv_bfloat16* W2S = W1S + (size_t)K * kState;                          // [K][4F][F]
  float* B1S = reinterpret_cast<float*>(W2S + (size_t)K * kState);         // [K][4F]
  float* B2S = B1S + (size_t)K * kF4;                                      // [K][F]
  float* dW1c = dW1 + (size_t)bh * kState;
  float* dW2c = dW2 + (size_t)bh * kState;
  const tttb::StepTiles t{w + kXQ, w + kXK, w + kTG, w + kZ1, w + kX2C, w + kG1, nullptr,
                          w + kZ2H, w + kGZ2, w + kG2, nullptr, nullptr};

  for (int i = tid; i < kState; i += kThreads) {
    dW1c[i] = 0.f;
    dW2c[i] = 0.f;
  }
  for (int i = tid; i < kTile; i += kThreads) {
    w[kDLNW + i] = 0.f;
    w[kDLNB + i] = 0.f;
  }
  s.db1[tid] = 0.f;
  if (tid < kF) {
    s.db2[tid] = 0.f;
    v.lnw[tid] = ln_w[(size_t)h * kF + tid];
    v.lnb[tid] = ln_b[(size_t)h * kF + tid];
  }
  __syncthreads();

  for (int g = NG - 1; g >= 0; --g) {
    const int n0 = g * K, valid = min(K, a.NC - n0);
    // Pass A: the forward from checkpoint g, stashing each step's state.
    const size_t ck = (size_t)bh * NG + g;
    for (int i = tid; i < kState; i += kThreads) {
      w[kW1 + i] = w1_ck[ck * kState + i];
      w[kW2 + i] = w2_ck[ck * kState + i];
    }
    v.b1[tid] = b1_ck[ck * kF4 + tid];
    if (tid < kF) v.b2[tid] = b2_ck[ck * kF + tid];
    __syncthreads();
    for (int i = 0; i < valid; ++i) {
      for (int e = tid; e < kState; e += kThreads) {
        W1S[(size_t)i * kState + e] = __float2bfloat16(w[kW1 + e]);
        W2S[(size_t)i * kState + e] = __float2bfloat16(w[kW2 + e]);
      }
      B1S[(size_t)i * kF4 + tid] = v.b1[tid];
      if (tid < kF) B2S[(size_t)i * kF + tid] = v.b2[tid];
      __syncthreads();
      tttb::forward_step(a, b, h, n0 + i, v, w + kW1, w + kW2, t, stage, nullptr);
    }
    // Pass B: the step VJP, last step first.
    for (int i = valid - 1; i >= 0; --i) {
      v.b1[tid] = B1S[(size_t)i * kF4 + tid];
      if (tid < kF) v.b2[tid] = B2S[(size_t)i * kF + tid];
      __syncthreads();
      backward_step(a, b, h, n0 + i, v, s, w, W1S + (size_t)i * kState, W2S + (size_t)i * kState, dout, dxq, dxk,
                    dxv, dgate, dW1c, dW2c, stage);
    }
  }

  db1[(size_t)bh * kF4 + tid] = s.db1[tid];
  if (tid < kF) {
    db2[(size_t)bh * kF + tid] = s.db2[tid];
    float sw = 0.f, sb = 0.f;
    for (int r = 0; r < kCS; ++r) {
      sw += w[kDLNW + r * kF + tid];
      sb += w[kDLNB + r * kF + tid];
    }
    dlnw[(size_t)bh * kF + tid] = sw;
    dlnb[(size_t)bh * kF + tid] = sb;
  }
}

long long workspace_bytes(int K) {
  const long long bytes = (long long)kWorkFloats * 4 + (long long)K * kState * 2 * 2 + (long long)K * (kF4 + kF) * 4;
  return (bytes + 255) / 256 * 256;
}

}  // namespace

extern "C" long long ttt_mlp_backward_workspace_bytes(int K) { return workspace_bytes(K); }

extern "C" int ttt_mlp_backward(const void* xq, const void* xk, const void* xv, const void* gate, const void* rope_cos,
                                const void* rope_sin, const void* ln_w, const void* ln_b, const void* w1_ck,
                                const void* b1_ck, const void* w2_ck, const void* b2_ck, const void* dout, void* dxq,
                                void* dxk, void* dxv, void* dgate, void* dW1, void* db1, void* dW2, void* db2,
                                void* dlnw, void* dlnb, void* work, int B, int NC, int H, int K, float eta_scale,
                                void* stream) {
  const tttb::ScanArgs a{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                         static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                         static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), NC, H, eta_scale};
  ttt_mlp_bwd_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(w1_ck),
      static_cast<const float*>(b1_ck), static_cast<const float*>(w2_ck), static_cast<const float*>(b2_ck),
      static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dxq), static_cast<__nv_bfloat16*>(dxk),
      static_cast<__nv_bfloat16*>(dxv), static_cast<float*>(dgate), static_cast<float*>(dW1),
      static_cast<float*>(db1), static_cast<float*>(dW2), static_cast<float*>(db2), static_cast<float*>(dlnw),
      static_cast<float*>(dlnb), static_cast<unsigned char*>(work), workspace_bytes(K), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
