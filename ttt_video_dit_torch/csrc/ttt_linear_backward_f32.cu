// Fused TTT-linear backward in float32 (K6), head_dim F = 64, every
// mini-batch CS of ops/ttt_linear_kernel.py:KERNEL_MINI_BATCHES, for Hopper
// (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_linear_bwd_kernel
// at dt = float32 (every `.astype(dt)` the identity), in the
// fused-preprocessing, token-major, in-kernel-gate form of the bf16 kernel
// (ttt_linear_backward.cu), with its signature. It is the VJP of the float32
// training forward (ttt_linear_forward_f32.cu) from that kernel's
// checkpoints: per (batch, head) it walks the checkpoint groups last to
// first; per group, pass A re-runs the forward from the group's checkpoint
// (ttt_f32.cuh:linear_step without the output) and stashes each step's state,
// and pass B walks the group backwards through the step VJP of
// ops/ttt_linear_kernel.py:ttt_linear_backward_plain (ttt_backward.py:501-584),
// line by line. Nothing is rounded to bf16.
//
// What bounds it on the H100: the operations, 18 CS F^2 + 12 CS^2 F flops a
// step and head, exact float32 products, and at CS 16 the latency of a
// step's chain of block-wide passes; one block per (batch, head), 48 of the
// 132 SMs at B = 1.
//
// Design (simple first, ttt_f32.cuh): one block of 256 threads per (batch,
// head); the step's state in shared memory; the stash (K states of 16.3 KiB
// a block), the intermediates and the gradient carries (the kernel's own
// outputs dW1, db1, dln_w, dln_b, accumulated in place) in device memory.
//
// Layouts: as ttt_linear_forward_f32.cu, and dout, dxq/dxk/dxv
// [B, NC, CS, H*F] f32, dgate [B, H, NC, CS] f32, dW1 [B, H, F, F], db1
// [B, H, 1, F], dln_w / dln_b [B, H, F] (the wrapper sums them over the
// batch).

#include "ttt_f32.cuh"

namespace {

using namespace tttf;

// Pass B's workspace after the forward step's: [CS][F] rows, [CS] scalars, [CS][CS] matrices, then the stash.
struct BwdWork {
  FwdWork fwd;
  size_t xq, xk, tgt, that, z1h, g1, Gs, zbh, dZb, dG, dXQ, dXK, dZ1, dtg, dgx;
  size_t sT, eta, sig, std1;
  size_t A1, dA1;
  size_t stash, floats;
  __host__ __device__ BwdWork(int cs, int K) : fwd(cs, false) {
    Bump m;
    m.off = fwd.floats;
    const size_t cf = (size_t)cs * kF, cc = (size_t)cs * cs;
    xq = m.take(cf), xk = m.take(cf), tgt = m.take(cf), that = m.take(cf), z1h = m.take(cf), g1 = m.take(cf);
    Gs = m.take(cf), zbh = m.take(cf), dZb = m.take(cf), dG = m.take(cf), dXQ = m.take(cf), dXK = m.take(cf);
    dZ1 = m.take(cf), dtg = m.take(cf), dgx = m.take(cf);
    sT = m.take(cs), eta = m.take(cs), sig = m.take(cs), std1 = m.take(cs);
    A1 = m.take(cc), dA1 = m.take(cc);
    stash = m.take((size_t)K * state_floats(false));
    floats = m.off;
  }
};

struct Args {
  Scan s;
  const float *w1_ck, *b1_ck, *dout;
  float *dxq, *dxk, *dxv, *dgate, *dW1, *db1, *dlnw, *dlnb;
  float* work;
  int K;
};

// The VJP of step n, from the step's state `st` (pass B).
__device__ void vjp_step(const Args& A, const Scan& S, int n, const State& st, float* w, const BwdWork& L,
                         float* stage, float* dW1, float* db1, float* dlnw, float* dlnb) {
  const int CS = S.CS, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = 2 * lane;
  float *xq = w + L.xq, *xk = w + L.xk, *tgt = w + L.tgt, *that = w + L.that, *z1h = w + L.z1h, *g1 = w + L.g1;
  float *Gs = w + L.Gs, *zbh = w + L.zbh, *dZb = w + L.dZb, *dG = w + L.dG, *dXQ = w + L.dXQ, *dXK = w + L.dXK;
  float *dZ1 = w + L.dZ1, *dtg = w + L.dtg, *dgx = w + L.dgx;
  float *sT = w + L.sT, *eta = w + L.eta, *sig = w + L.sig, *std1 = w + L.std1, *A1 = w + L.A1, *dA1 = w + L.dA1;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);

  prep(S, n, xq, xk, tgt, that, sT, eta, sig);
  // Recompute the step's forward intermediates: Z1 = XK W + b, g1 = ln_fused_l2(Z1, target), Gs = eta g1.
  gemm(z1h, kF, CS, kF, kF, rm(xk, kF), rm(st.W1, kF), 1.f, 0.f, stage);
  {
    const float2 b = ld2(st.b1 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(z1h, r, lane);
      float sd;
      const float2 xh = ln_hat(f2(z.x + b.x, z.y + b.y), sd);
      const float2 g = ln_fused_l2(xh, sd, row2(tgt, r, lane), lw, lb);
      st2(z1h + r * kF + f, xh);
      st2(g1 + r * kF + f, g);
      st2(Gs + r * kF + f, f2(eta[r] * g.x, eta[r] * g.y));
      if (lane == 0) std1[r] = sd;
    }
    __syncthreads();
  }
  gemm(A1, CS, CS, CS, kF, rm(xq, kF), tr(xk, kF), 1.f, 0.f, stage);  // A1 = XQ XK^T
  colsum(st.b1, Gs, CS, kF, -1.f);                                     // b - colsum(Gs)
  gemm(zbh, kF, CS, kF, kF, rm(xq, kF), rm(st.W1, kF), 1.f, 0.f, stage);  // Zb1 = XQ W - A1 Gs + b'
  gemm(zbh, kF, CS, kF, CS, rm(A1, CS), rm(Gs, kF), -1.f, 1.f, stage);

  // out = XQ + LN(Zb1): dZb1, and dXQ starts as dout.
  {
    const float2 b = ld2(st.b1 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(zbh, r, lane), u = ld2(A.dout + S.tok(n, r) + f);
      float sd;
      const float2 xh = ln_hat(f2(z.x + b.x, z.y + b.y), sd);
      const float2 wv = f2(lw.x * u.x, lw.y * u.y);
      const float m1 = warp_sum(wv.x + wv.y) / kF, m2 = warp_sum(wv.x * xh.x + wv.y * xh.y) / kF;
      st2(zbh + r * kF + f, xh);
      st2(dZb + r * kF + f, f2((wv.x - m1 - xh.x * m2) / sd, (wv.y - m1 - xh.y * m2) / sd));
      st2(dXQ + r * kF + f, u);
    }
    __syncthreads();
  }
  // Zb1 = XQ W - A1 Gs + b': dXQ, dA1, db (the carry now db_tot), dG.
  gemm(dXQ, kF, CS, kF, kF, rm(dZb, kF), tr(st.W1, kF), 1.f, 1.f, stage);
  gemm(dA1, CS, CS, CS, kF, rm(dZb, kF), tr(Gs, kF), -1.f, 0.f, stage);
  colsum(db1, dZb, CS, kF, 1.f);
  gemm(dG, kF, CS, kF, CS, tr(A1, CS), rm(dZb, kF), -1.f, 0.f, stage);
  for (int i = threadIdx.x; i < CS * kF; i += kThreads) dG[i] -= db1[i % kF];
  __syncthreads();
  // W' = W - XK^T Gs: the carry dW before this step's contributions.
  gemm(dXK, kF, CS, kF, kF, rm(Gs, kF), tr(dW1, kF), -1.f, 0.f, stage);
  gemm(dG, kF, CS, kF, kF, rm(xk, kF), rm(dW1, kF), -1.f, 1.f, stage);
  // A1 = XQ XK^T
  gemm(dXQ, kF, CS, kF, CS, rm(dA1, CS), rm(xk, kF), 1.f, 1.f, stage);
  gemm(dXK, kF, CS, kF, CS, tr(dA1, CS), rm(xq, kF), 1.f, 1.f, stage);
  // Gs = eta g1: de, d_gate, dg1 = eta dG; then g1 = ln_fused_l2(Z1, target): dZ1, dtarget, the affine's rows.
  for (int r = warp; r < CS; r += kWarps) {
    const float e = eta[r];
    const float2 a = row2(dG, r, lane), g = row2(g1, r, lane);
    const float de = warp_sum(a.x * g.x + a.y * g.y);
    if (lane == 0) A.dgate[S.gate_at(n) + r] = de * e * (1.f - sig[r]);
    const float2 u = f2(e * a.x, e * a.y);
    const float2 xh = row2(z1h, r, lane), tg = row2(tgt, r, lane);
    const float sd = std1[r];
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
    st2(dZ1 + r * kF + f, f2((dxh.x - md - xh.x * mdx) / sd + dstd * xh.x / kF,
                             (dxh.y - md - xh.y * mdx) / sd + dstd * xh.y / kF));
    st2(dtg + r * kF + f, f2(-lw.x * dg.x, -lw.y * dg.y));
    st2(dgx + r * kF + f, dg);
  }
  __syncthreads();
  // target = LN-reconstruction(XV - XK): dXV, and dXK -= it.
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
  // Z1 = XK W + b
  gemm(dXK, kF, CS, kF, kF, rm(dZ1, kF), tr(st.W1, kF), 1.f, 1.f, stage);
  colsum(db1, dZ1, CS, kF, 1.f);
  // rope, then the L2 norm, back to the raw projections.
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
      const float u = A.dout[S.tok(n, r) + j], xh = z1h[i], dg = dgx[i], ut = dtg[i];
      gw += u * zbh[i] + dg * (lwj * xh + lbj - tgt[i]) + dg * lwj * xh + ut * that[i];
      gb += u + dg * lwj + ut;
    }
    dlnw[j] += gw;
    dlnb[j] += gb;
  }
  __syncthreads();
  // The carry: dW += XQ^T dZb1 + XK^T dZ1.
  gemm(dW1, kF, kF, kF, CS, tr(xq, kF), rm(dZb, kF), 1.f, 1.f, stage);
  gemm(dW1, kF, kF, kF, CS, tr(xk, kF), rm(dZ1, kF), 1.f, 1.f, stage);
}

__global__ void __launch_bounds__(kThreads, 1) ttt_linear_bwd_f32_kernel(const Args A) {
  extern __shared__ __align__(16) float smem[];
  const State st = state_at(smem, false);
  float* stage = smem + state_floats(false);
  Scan S = A.s;
  S.b = blockIdx.x / S.H, S.h = blockIdx.x % S.H;
  const int NC = S.NC, K = A.K, NG = (NC + K - 1) / K;
  const BwdWork L(S.CS, K);
  float* w = A.work + (size_t)blockIdx.x * L.floats;
  const size_t bh = blockIdx.x;
  float *dW1 = A.dW1 + bh * kF * kF, *db1 = A.db1 + bh * kF, *dlnw = A.dlnw + bh * kF, *dlnb = A.dlnb + bh * kF;
  for (int i = threadIdx.x; i < kF * kF; i += kThreads) dW1[i] = 0.f;
  for (int i = threadIdx.x; i < kF; i += kThreads) db1[i] = dlnw[i] = dlnb[i] = 0.f;
  __syncthreads();
  const int SF = state_floats(false);
  for (int g = NG - 1; g >= 0; --g) {
    const int n0 = g * K, steps = min(K, NC - n0);
    // Pass A: the forward from the group's checkpoint, stashing the state before each step.
    const size_t c = bh * NG + g;
    load_state(st, A.w1_ck + c * kF * kF, A.b1_ck + c * kF, nullptr, nullptr, false);
    for (int i = 0; i < steps; ++i) {
      copy(w + L.stash + (size_t)i * SF, st.W1, SF);
      if (i + 1 < steps) linear_step(S, n0 + i, st, w, L.fwd, stage, nullptr);
    }
    // Pass B: the step VJP, last step first.
    for (int i = steps - 1; i >= 0; --i) {
      copy(st.W1, w + L.stash + (size_t)i * SF, SF);
      vjp_step(A, S, n0 + i, st, w, L, stage, dW1, db1, dlnw, dlnb);
    }
  }
}

constexpr int kSmemBytes = (state_floats(false) + kStageFloats) * 4;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");

}  // namespace

extern "C" int ttt_linear_backward_f32_smem_bytes(int cs) {
  return takes_mini_batch(cs) ? kSmemBytes : -static_cast<int>(cudaErrorInvalidValue);
}

// Floats of one block's workspace at mini-batch cs and checkpoint group K; the wrapper allocates B * H of them.
extern "C" long long ttt_linear_backward_f32_workspace_floats(int cs, int K) {
  return (long long)BwdWork(cs, K).floats;
}

extern "C" int ttt_linear_backward_f32(const void* xq, const void* xk, const void* xv, const void* gate,
                                       const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                       const void* w1_ck, const void* b1_ck, const void* dout, void* dxq, void* dxk,
                                       void* dxv, void* dgate, void* dW1, void* db1, void* dln_w, void* dln_b,
                                       void* work, int B, int NC, int H, int CS, int K, float eta_scale, void* stream) {
  if (!takes_mini_batch(CS) || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args A{Scan{static_cast<const float*>(xq), static_cast<const float*>(xk), static_cast<const float*>(xv),
                    static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                    static_cast<const float*>(rope_sin), static_cast<const float*>(ln_w),
                    static_cast<const float*>(ln_b), NC, H, CS, eta_scale, 0, 0},
               static_cast<const float*>(w1_ck), static_cast<const float*>(b1_ck), static_cast<const float*>(dout),
               static_cast<float*>(dxq), static_cast<float*>(dxk), static_cast<float*>(dxv),
               static_cast<float*>(dgate), static_cast<float*>(dW1), static_cast<float*>(db1),
               static_cast<float*>(dln_w), static_cast<float*>(dln_b), static_cast<float*>(work), K};
  return launch(ttt_linear_bwd_f32_kernel, B * H, kSmemBytes, stream, A);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
