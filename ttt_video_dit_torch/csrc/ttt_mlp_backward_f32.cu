// Fused TTT-MLP backward in float32 (K2), head_dim F = 64, every mini-batch
// CS of ops/ttt_mlp_kernel.py:KERNEL_MINI_BATCHES, for Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_mlp_bwd_kernel at
// dt = xq_ref.dtype = float32 (l.208: every `.astype(dt)` of l.227-253 and
// l.282-338 is the identity), in the fused-preprocessing, token-major,
// in-kernel-gate form of the bf16 kernel (ttt_mlp_backward.cu), with its
// signature. It is the VJP of the float32 training forward
// (ttt_mlp_forward_f32.cu) from that kernel's checkpoints: per (batch, head)
// it walks the checkpoint groups last to first; per group, pass A re-runs the
// forward from the group's checkpoint (ttt_f32.cuh:mlp_step without the
// output) and stashes each step's state, and pass B walks the group
// backwards through the hand-derived step VJP of
// ops/ttt_mlp_kernel.py:ttt_mlp_backward_plain, line by line: the
// second-order LN term, GELU'', the preprocessing VJPs (target LN, rope, L2
// norm) and the sigmoid gate, d_gate = de * eta * (1 - sigmoid). Nothing is
// rounded to bf16.
//
// What bounds it on the H100: the operations, 168 CS F^2 + 60 CS^2 F flops a
// step and head for the VJP and the forward it needs (pass A's re-run of the
// state update on top), exact float32 products, on one block per (batch,
// head): 48 of the 132 SMs at B = 1.
//
// Design (simple first, ttt_f32.cuh): one block of 256 threads per (batch,
// head); the state of the step in shared memory (pass A's running state; in
// pass B the step's stashed state, copied in); the stash (K states of 132 KiB
// a block), every per-step intermediate, and the gradient carries (dW1, db1,
// dW2, db2, dln_w, dln_b: the kernel's own outputs, accumulated in place) in
// device memory. Each output of the step VJP is one block-wide pass; the
// state cotangents of step (6) are read before this step's contributions are
// added, as in the plain version.
//
// Layouts: as ttt_mlp_forward_f32.cu, and dout, dxq/dxk/dxv [B, NC, CS, H*F]
// f32, dgate [B, H, NC, CS] f32, dW1 [B, H, F, 4F], db1 [B, H, 1, 4F], dW2
// [B, H, 4F, F], db2 [B, H, 1, F], dln_w / dln_b [B, H, F] (the wrapper sums
// them over the batch).

#include "ttt_f32.cuh"

namespace {

using namespace tttf;

// Pass B's workspace after the forward step's: [CS][F] rows, [CS] scalars, [CS][4F] and [CS][CS] matrices, then
// the stash of K states.
struct BwdWork {
  FwdWork fwd;
  size_t xq, xk, tgt, that, z2h, g2, G2, zb2h, dZb2, dG2, dXQ, dXK, dZ2, dtg, dgx;
  size_t sT, eta, sig, std2;
  size_t Z1, X2, P, G1, Zb1, Xb2, dZb1, dX2, dG1, dZ1;
  size_t A1, A2, dA1, dA2;
  size_t stash, floats;
  __host__ __device__ BwdWork(int cs, int K) : fwd(cs, true) {
    Bump m;
    m.off = fwd.floats;
    const size_t cf = (size_t)cs * kF, ch = (size_t)cs * kH4, cc = (size_t)cs * cs;
    xq = m.take(cf), xk = m.take(cf), tgt = m.take(cf), that = m.take(cf), z2h = m.take(cf), g2 = m.take(cf);
    G2 = m.take(cf), zb2h = m.take(cf), dZb2 = m.take(cf), dG2 = m.take(cf), dXQ = m.take(cf), dXK = m.take(cf);
    dZ2 = m.take(cf), dtg = m.take(cf), dgx = m.take(cf);
    sT = m.take(cs), eta = m.take(cs), sig = m.take(cs), std2 = m.take(cs);
    Z1 = m.take(ch), X2 = m.take(ch), P = m.take(ch), G1 = m.take(ch), Zb1 = m.take(ch), Xb2 = m.take(ch);
    dZb1 = m.take(ch), dX2 = m.take(ch), dG1 = m.take(ch), dZ1 = m.take(ch);
    A1 = m.take(cc), A2 = m.take(cc), dA1 = m.take(cc), dA2 = m.take(cc);
    stash = m.take((size_t)K * state_floats(true));
    floats = m.off;
  }
};

struct Args {
  Scan s;
  const float *w1_ck, *b1_ck, *w2_ck, *b2_ck, *dout;
  float *dxq, *dxk, *dxv, *dgate, *dW1, *db1, *dW2, *db2, *dlnw, *dlnb;
  float* work;
  int K;
};

// The VJP of step n, from the step's state `st` (pass B).
__device__ void vjp_step(const Args& A, const Scan& S, int n, const State& st, float* w, const BwdWork& L,
                         float* stage, float* dW1, float* db1, float* dW2, float* db2, float* dlnw, float* dlnb) {
  const int CS = S.CS, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = 2 * lane;
  float *xq = w + L.xq, *xk = w + L.xk, *tgt = w + L.tgt, *that = w + L.that, *z2h = w + L.z2h, *g2 = w + L.g2;
  float *G2 = w + L.G2, *zb2h = w + L.zb2h, *dZb2 = w + L.dZb2, *dG2 = w + L.dG2, *dXQ = w + L.dXQ;
  float *dXK = w + L.dXK, *dZ2 = w + L.dZ2, *dtg = w + L.dtg, *dgx = w + L.dgx;
  float *sT = w + L.sT, *eta = w + L.eta, *sig = w + L.sig, *std2 = w + L.std2;
  float *Z1 = w + L.Z1, *X2 = w + L.X2, *P = w + L.P, *G1 = w + L.G1, *Zb1 = w + L.Zb1, *Xb2 = w + L.Xb2;
  float *dZb1 = w + L.dZb1, *dX2 = w + L.dX2, *dG1 = w + L.dG1, *dZ1 = w + L.dZ1;
  float *A1 = w + L.A1, *A2 = w + L.A2, *dA1 = w + L.dA1, *dA2 = w + L.dA2;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);
  const int CH = CS * kH4;

  prep(S, n, xq, xk, tgt, that, sT, eta, sig);
  // Recompute the step's forward intermediates.
  gemm(Z1, kH4, CS, kH4, kF, rm(xk, kF), rm(st.W1, kH4), 1.f, 0.f, stage);  // Z1 = XK W1 + b1
  for (int i = threadIdx.x; i < CH; i += kThreads) {
    const float z = Z1[i] + st.b1[i % kH4];
    Z1[i] = z;
    X2[i] = gelu(z);
  }
  __syncthreads();
  gemm(z2h, kF, CS, kF, kH4, rm(X2, kH4), rm(st.W2, kF), 1.f, 0.f, stage);  // Z2 = X2 W2 + b2
  {
    const float2 b2 = ld2(st.b2 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(z2h, r, lane);
      float sd;
      const float2 xh = ln_hat(f2(z.x + b2.x, z.y + b2.y), sd);
      const float2 g = ln_fused_l2(xh, sd, row2(tgt, r, lane), lw, lb);
      st2(z2h + r * kF + f, xh);
      st2(g2 + r * kF + f, g);
      st2(G2 + r * kF + f, f2(eta[r] * g.x, eta[r] * g.y));
      if (lane == 0) std2[r] = sd;
    }
    __syncthreads();
  }
  gemm(P, kH4, CS, kH4, kF, rm(g2, kF), tr(st.W2, kF), 1.f, 0.f, stage);  // P = g2 W2^T
  for (int i = threadIdx.x; i < CH; i += kThreads) G1[i] = eta[i / kH4] * P[i] * gelu_bwd(Z1[i]);
  __syncthreads();
  gemm(A1, CS, CS, CS, kF, rm(xq, kF), tr(xk, kF), 1.f, 0.f, stage);  // A1 = XQ XK^T
  colsum(st.b1, G1, CS, kH4, -1.f);                                    // b1 - colsum(G1)
  colsum(st.b2, G2, CS, kF, -1.f);                                     // b2 - colsum(G2)
  gemm(Zb1, kH4, CS, kH4, kF, rm(xq, kF), rm(st.W1, kH4), 1.f, 0.f, stage);  // Zb1 = XQ W1 - A1 G1 + b1'
  gemm(Zb1, kH4, CS, kH4, CS, rm(A1, CS), rm(G1, kH4), -1.f, 1.f, stage);
  for (int i = threadIdx.x; i < CH; i += kThreads) {
    const float z = Zb1[i] + st.b1[i % kH4];
    Zb1[i] = z;
    Xb2[i] = gelu(z);
  }
  __syncthreads();
  gemm(A2, CS, CS, CS, kH4, rm(Xb2, kH4), tr(X2, kH4), 1.f, 0.f, stage);  // A2 = Xb2 X2^T
  gemm(zb2h, kF, CS, kF, kH4, rm(Xb2, kH4), rm(st.W2, kF), 1.f, 0.f, stage);  // Zb2 = Xb2 W2 - A2 G2 + b2'
  gemm(zb2h, kF, CS, kF, CS, rm(A2, CS), rm(G2, kF), -1.f, 1.f, stage);

  // (1) out = XQ + LN(Zb2): dZb2, and dXQ starts as dout.
  {
    const float2 b2 = ld2(st.b2 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(zb2h, r, lane), u = ld2(A.dout + S.tok(n, r) + f);
      float sd;
      const float2 xh = ln_hat(f2(z.x + b2.x, z.y + b2.y), sd);
      const float2 wv = f2(lw.x * u.x, lw.y * u.y);
      const float m1 = warp_sum(wv.x + wv.y) / kF, m2 = warp_sum(wv.x * xh.x + wv.y * xh.y) / kF;
      st2(zb2h + r * kF + f, xh);
      st2(dZb2 + r * kF + f, f2((wv.x - m1 - xh.x * m2) / sd, (wv.y - m1 - xh.y * m2) / sd));
      st2(dXQ + r * kF + f, u);
    }
    __syncthreads();
  }
  // (2) Zb2 = Xb2 W2 - A2 G2 + b2': dXb2 (in dZb1), dA2, db2 (the carry now db2_tot), dG2.
  gemm(dZb1, kH4, CS, kH4, kF, rm(dZb2, kF), tr(st.W2, kF), 1.f, 0.f, stage);
  gemm(dA2, CS, CS, CS, kF, rm(dZb2, kF), tr(G2, kF), -1.f, 0.f, stage);
  colsum(db2, dZb2, CS, kF, 1.f);
  gemm(dG2, kF, CS, kF, CS, tr(A2, CS), rm(dZb2, kF), -1.f, 0.f, stage);
  for (int i = threadIdx.x; i < CS * kF; i += kThreads) dG2[i] -= db2[i % kF];
  __syncthreads();
  // (3) A2 = Xb2 X2^T
  gemm(dZb1, kH4, CS, kH4, CS, rm(dA2, CS), rm(X2, kH4), 1.f, 1.f, stage);
  gemm(dX2, kH4, CS, kH4, CS, tr(dA2, CS), rm(Xb2, kH4), 1.f, 0.f, stage);
  // (4) Xb2 = gelu(Zb1)
  for (int i = threadIdx.x; i < CH; i += kThreads) dZb1[i] *= gelu_bwd(Zb1[i]);
  __syncthreads();
  // (5) Zb1 = XQ W1 - A1 G1 + b1': dXQ, dA1, db1 (the carry now db1_tot), dG1.
  gemm(dXQ, kF, CS, kF, kH4, rm(dZb1, kH4), tr(st.W1, kH4), 1.f, 1.f, stage);
  gemm(dA1, CS, CS, CS, kH4, rm(dZb1, kH4), tr(G1, kH4), -1.f, 0.f, stage);
  colsum(db1, dZb1, CS, kH4, 1.f);
  gemm(dG1, kH4, CS, kH4, CS, tr(A1, CS), rm(dZb1, kH4), -1.f, 0.f, stage);
  for (int i = threadIdx.x; i < CH; i += kThreads) dG1[i] -= db1[i % kH4];
  __syncthreads();
  // (6) the state updates W' = W - X^T G: the carries dW1, dW2 before this step's contributions.
  gemm(dX2, kH4, CS, kH4, kF, rm(G2, kF), tr(dW2, kF), -1.f, 1.f, stage);
  gemm(dG2, kF, CS, kF, kH4, rm(X2, kH4), rm(dW2, kF), -1.f, 1.f, stage);
  gemm(dXK, kF, CS, kF, kH4, rm(G1, kH4), tr(dW1, kH4), -1.f, 0.f, stage);
  gemm(dG1, kH4, CS, kH4, kF, rm(xk, kF), rm(dW1, kH4), -1.f, 1.f, stage);
  // (7) A1 = XQ XK^T
  gemm(dXQ, kF, CS, kF, CS, rm(dA1, CS), rm(xk, kF), 1.f, 1.f, stage);
  gemm(dXK, kF, CS, kF, CS, tr(dA1, CS), rm(xq, kF), 1.f, 1.f, stage);
  // (8)-(9) G = eta g: de and d_gate; dg2 = eta dG2 (in dG2), dZ1 = dg1 P gelu''(Z1), dP = dg1 gelu'(Z1) (in dG1).
  for (int r = warp; r < CS; r += kWarps) {
    const float e = eta[r];
    const float2 a = row2(dG2, r, lane), g = row2(g2, r, lane);
    float s = a.x * g.x + a.y * g.y;
    const size_t o = (size_t)r * kH4;
    for (int j = lane; j < kH4; j += 32) s += dG1[o + j] * P[o + j] * gelu_bwd(Z1[o + j]);
    const float de = warp_sum(s);
    if (lane == 0) A.dgate[S.gate_at(n) + r] = de * e * (1.f - sig[r]);
    st2(dG2 + r * kF + f, f2(e * a.x, e * a.y));
    for (int j = lane; j < kH4; j += 32) {
      const float dg1 = e * dG1[o + j], z = Z1[o + j];
      dZ1[o + j] = dg1 * P[o + j] * gelu_bwd2(z);
      dG1[o + j] = dg1 * gelu_bwd(z);
    }
  }
  __syncthreads();
  gemm(dG2, kF, CS, kF, kH4, rm(dG1, kH4), rm(st.W2, kF), 1.f, 1.f, stage);  // dg2 += dP W2
  // (10) g2 = ln_fused_l2(Z2, target): dZ2, dtarget and the LN affine's rows (dgx).
  for (int r = warp; r < CS; r += kWarps) {
    const float2 xh = row2(z2h, r, lane), tg = row2(tgt, r, lane), u = row2(dG2, r, lane);
    const float sd = std2[r];
    const float2 y = f2(lw.x * xh.x + lb.x, lw.y * xh.y + lb.y);
    const float2 gx = f2(lw.x * (y.x - tg.x), lw.y * (y.y - tg.y));
    const float mg = warp_sum(gx.x + gx.y) / kF, m2 = warp_sum(gx.x * xh.x + gx.y * xh.y) / kF;
    const float2 z = f2((gx.x - mg - xh.x * m2) / sd, (gx.y - mg - xh.y * m2) / sd);
    const float mu = warp_sum(u.x + u.y) / kF, mux = warp_sum(u.x * xh.x + u.y * xh.y) / kF;
    const float2 dg = f2((u.x - mu - xh.x * mux) / sd, (u.y - mu - xh.y * mux) / sd);
    const float2 dxh = f2(-(m2 * u.x + gx.x * mux) / sd + lw.x * lw.x * dg.x,
                          -(m2 * u.y + gx.y * mux) / sd + lw.y * lw.y * dg.y);
    const float dstd = -warp_sum(u.x * z.x + u.y * z.y) / sd;
    const float md = warp_sum(dxh.x + dxh.y) / kF, mdx = warp_sum(dxh.x * xh.x + dxh.y * xh.y) / kF;
    st2(dZ2 + r * kF + f, f2((dxh.x - md - xh.x * mdx) / sd + dstd * xh.x / kF,
                             (dxh.y - md - xh.y * mdx) / sd + dstd * xh.y / kF));
    st2(dtg + r * kF + f, f2(-lw.x * dg.x, -lw.y * dg.y));
    st2(dgx + r * kF + f, dg);
  }
  __syncthreads();
  // (11) Z2 = X2 W2 + b2
  gemm(dX2, kH4, CS, kH4, kF, rm(dZ2, kF), tr(st.W2, kF), 1.f, 1.f, stage);
  colsum(db2, dZ2, CS, kF, 1.f);
  // (12) target = LN-reconstruction(XV - XK): dXV, and dXK -= it.
  for (int r = warp; r < CS; r += kWarps) {
    const float2 th = row2(that, r, lane), u = row2(dtg, r, lane);
    const float s = sT[r], sqrtv = fmaxf(s - 1e-8f, 1e-20f);
    const float2 g = f2(lw.x * u.x, lw.y * u.y);
    const float mg = warp_sum(g.x + g.y) / kF, gt = warp_sum(g.x * th.x + g.y * th.y) / ((kF - 1) * sqrtv);
    const float2 dt = f2((g.x - mg) / s - th.x * gt, (g.y - mg) / s - th.y * gt);
    const float2 k = row2(dXK, r, lane);
    st2(dXK + r * kF + f, f2(k.x - dt.x, k.y - dt.y));
    st2(A.dxv + S.tok(n, r) + f, dt);
  }
  __syncthreads();
  // (13) X2 = gelu(Z1); (14) Z1 = XK W1 + b1
  for (int i = threadIdx.x; i < CH; i += kThreads) dZ1[i] += gelu_bwd(Z1[i]) * dX2[i];
  __syncthreads();
  gemm(dXK, kF, CS, kF, kH4, rm(dZ1, kH4), tr(st.W1, kH4), 1.f, 1.f, stage);
  colsum(db1, dZ1, CS, kH4, 1.f);
  // (15) rope, then the L2 norm, back to the raw projections.
  for (int r = warp; r < CS; r += kWarps) {
    const size_t t = S.tab(n, r) + f, o = S.tok(n, r) + f;
    const float2 c = ld2(S.cos + t), sn = ld2(S.sin + t);
    for (int which = 0; which < 2; ++which) {
      const float2 u = row2(which ? dXK : dXQ, r, lane), x = ld2((which ? S.xk : S.xq) + o);
      const float2 v = f2(u.x * c.x + u.y * sn.x, u.y * c.y - u.x * sn.y);  // rope's VJP
      const float nrm = sqrtf(warp_sum(x.x * x.x + x.y * x.y)), m = fmaxf(nrm, 1e-12f);
      const float proj = warp_sum(v.x * x.x + v.y * x.y);
      const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
      st2((which ? A.dxk : A.dxq) + o, f2(v.x / m - x.x * corr, v.y / m - x.y * corr));
    }
  }
  // The LN affine's gradient: out's LN, the fused-L2 term's and the target's.
  for (int j = threadIdx.x; j < kF; j += kThreads) {
    const float lwj = S.ln_w[(size_t)S.h * kF + j], lbj = S.ln_b[(size_t)S.h * kF + j];
    float gw = 0.f, gb = 0.f;
    for (int r = 0; r < CS; ++r) {
      const size_t i = (size_t)r * kF + j;
      const float u = A.dout[S.tok(n, r) + j], xh = z2h[i], dg = dgx[i], ut = dtg[i];
      gw += u * zb2h[i] + dg * (lwj * xh + lbj - tgt[i]) + dg * lwj * xh + ut * that[i];
      gb += u + dg * lwj + ut;
    }
    dlnw[j] += gw;
    dlnb[j] += gb;
  }
  __syncthreads();
  // The carries: dW1 += XQ^T dZb1 + XK^T dZ1, dW2 += Xb2^T dZb2 + dP^T g2 + X2^T dZ2.
  gemm(dW1, kH4, kF, kH4, CS, tr(xq, kF), rm(dZb1, kH4), 1.f, 1.f, stage);
  gemm(dW1, kH4, kF, kH4, CS, tr(xk, kF), rm(dZ1, kH4), 1.f, 1.f, stage);
  gemm(dW2, kF, kH4, kF, CS, tr(Xb2, kH4), rm(dZb2, kF), 1.f, 1.f, stage);
  gemm(dW2, kF, kH4, kF, CS, tr(dG1, kH4), rm(g2, kF), 1.f, 1.f, stage);
  gemm(dW2, kF, kH4, kF, CS, tr(X2, kH4), rm(dZ2, kF), 1.f, 1.f, stage);
}

__global__ void __launch_bounds__(kThreads, 1) ttt_mlp_bwd_f32_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  const State st = state_at(smem, true);
  float* stage = smem + state_floats(true);
  Scan S = A.s;
  S.b = blockIdx.x / S.H, S.h = blockIdx.x % S.H;
  const int NC = S.NC, K = A.K, NG = (NC + K - 1) / K;
  const BwdWork L(S.CS, K);
  float* w = A.work + (size_t)blockIdx.x * L.floats;
  const size_t bh = blockIdx.x;
  float *dW1 = A.dW1 + bh * kF * kH4, *db1 = A.db1 + bh * kH4, *dW2 = A.dW2 + bh * kH4 * kF, *db2 = A.db2 + bh * kF;
  float *dlnw = A.dlnw + bh * kF, *dlnb = A.dlnb + bh * kF;
  for (int i = threadIdx.x; i < kF * kH4; i += kThreads) dW1[i] = dW2[i] = 0.f;
  for (int i = threadIdx.x; i < kH4; i += kThreads) db1[i] = 0.f;
  for (int i = threadIdx.x; i < kF; i += kThreads) db2[i] = dlnw[i] = dlnb[i] = 0.f;
  __syncthreads();
  const int SF = state_floats(true);
  for (int g = NG - 1; g >= 0; --g) {
    const int n0 = g * K, steps = min(K, NC - n0);
    // Pass A: the forward from the group's checkpoint, stashing the state before each step.
    const size_t c = bh * NG + g;
    load_state(st, A.w1_ck + c * kF * kH4, A.b1_ck + c * kH4, A.w2_ck + c * kH4 * kF, A.b2_ck + c * kF, true);
    for (int i = 0; i < steps; ++i) {
      copy(w + L.stash + (size_t)i * SF, st.W1, SF);
      if (i + 1 < steps) mlp_step(S, n0 + i, st, w, L.fwd, stage, nullptr);
    }
    // Pass B: the step VJP, last step first.
    for (int i = steps - 1; i >= 0; --i) {
      copy(st.W1, w + L.stash + (size_t)i * SF, SF);
      vjp_step(A, S, n0 + i, st, w, L, stage, dW1, db1, dW2, db2, dlnw, dlnb);
    }
  }
}

constexpr int kSmemBytes = (state_floats(true) + kStageFloats) * 4;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");

}  // namespace

extern "C" int ttt_mlp_backward_f32_smem_bytes(int cs) {
  return takes_mini_batch(cs) ? kSmemBytes : -static_cast<int>(cudaErrorInvalidValue);
}

// Floats of one block's workspace at mini-batch cs and checkpoint group K; the wrapper allocates B * H of them.
extern "C" long long ttt_mlp_backward_f32_workspace_floats(int cs, int K) {
  return (long long)BwdWork(cs, K).floats;
}

extern "C" int ttt_mlp_backward_f32(const void* xq, const void* xk, const void* xv, const void* gate,
                                    const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                    const void* w1_ck, const void* b1_ck, const void* w2_ck, const void* b2_ck,
                                    const void* dout, void* dxq, void* dxk, void* dxv, void* dgate, void* dW1,
                                    void* db1, void* dW2, void* db2, void* dln_w, void* dln_b, void* work, int B,
                                    int NC, int H, int CS, int K, float eta_scale, void* stream) {
  if (!takes_mini_batch(CS) || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{Scan{static_cast<const float*>(xq), static_cast<const float*>(xk), static_cast<const float*>(xv),
                    static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                    static_cast<const float*>(rope_sin), static_cast<const float*>(ln_w),
                    static_cast<const float*>(ln_b), NC, H, CS, eta_scale, 0, 0},
               static_cast<const float*>(w1_ck), static_cast<const float*>(b1_ck), static_cast<const float*>(w2_ck),
               static_cast<const float*>(b2_ck), static_cast<const float*>(dout), static_cast<float*>(dxq),
               static_cast<float*>(dxk), static_cast<float*>(dxv), static_cast<float*>(dgate),
               static_cast<float*>(dW1), static_cast<float*>(db1), static_cast<float*>(dW2), static_cast<float*>(db2),
               static_cast<float*>(dln_w), static_cast<float*>(dln_b), static_cast<float*>(work), K};
  return launch(ttt_mlp_bwd_f32_kernel, B * H, kSmemBytes, stream, A);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
