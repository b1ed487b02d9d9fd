// Fused TTT-linear backward (K6), head_dim F = 64, mini-batch CS = 16, for
// Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_linear_bwd_kernel
// (launched by ttt_linear_backward, l.594, and reduced by
// ttt_vjp.py:_linear_bwd_pre), in its fused-preprocessing, token-major,
// in-kernel-gate form. It is the VJP of the training forward scan
// (ttt_linear_forward.cu with K > 0) from that kernel's fp32 state
// checkpoints: per (batch, head) it walks the checkpoint groups last to
// first (the ragged group first); per group, pass A re-runs the forward from
// the group's checkpoint and stashes each step's state, and pass B walks the
// group backwards through the hand-derived step VJP (ttt_backward.py:501-584):
// the output LN, the dual-form products, the second-order LN term, the target
// LN, rope and L2-norm VJPs and the sigmoid gate, d_gate = de * eta * (1 - sigmoid).
//
// What bounds it on the H100: as in the forward, the scan is sequential, so
// one block owns one (batch, head) and the limit is the latency of one step
// inside an SM (about 13 small products, ~1 MFLOP, and ten block-wide
// barriers per step of pass B; three products and four barriers per step of
// pass A). Device memory is not the limit.
//
// Design: one block of 256 threads per (batch, head), everything of a step in
// shared memory (77 KB, dynamic): the state W of the step (fp32, row stride
// 65 so both W[k][c] and W[c][k] walks are free of bank conflicts), the
// fp32 carry dW (likewise), and the [CS][F] step tiles. Only the pass-A
// stash goes to device memory: K steps x W in bf16 (exact: pass B uses W
// only rounded) and b in fp32, a wrapper-allocated workspace (8.25 KiB a
// step), so any K works. No atomics: each block owns its outputs. A thread
// owns column c of the [CS][F] tiles over four rows and of the [F][F] tiles
// over 16 rows; the four threads of a column keep identical copies of b[c]
// and of the bias carry db[c] in registers; row-wise phases keep each row's
// target, LN statistics, gradient and raw inputs in registers
// (ttt_linear_block.cuh). Operands are rounded to bf16 where the Pallas
// kernel calls .astype(dt): XQ, XK, W, Gs, A1, dZb1, dA1, the carry dW and
// dZ1. The LN-parameter cotangents are summed per lane over its rows and the
// whole scan and reduced across the warps once at the end; the LN and bias
// gradients come out compact ([F]) per (batch, head), and the wrapper sums
// them over the batch.
// Not yet done (later work): tensor cores, a second scan per SM.
//
// Layouts: as ttt_linear_forward.cu; dout/dxq/dxk/dxv [B, NC, CS, H*F] bf16;
// dgate [B, H, NC, CS] f32; checkpoints W1 [B, H, NG, F, F], b1
// [B, H, NG, 1, F] f32; outputs dW1 [B, H, F, F], db1 [B, H, 1, F],
// dln_w/dln_b [B, H, F] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ttt_linear_block.cuh"

namespace {

using namespace tttl;

constexpr int kLdW = kF + 1;  // row stride of W and dW in shared memory

// Shared-memory carve-up, in floats.
enum : int {
  kOffW = 0,                        // [F][kLdW] W of the step (pass A: the fp32 state; pass B: the stash)
  kOffDW = kOffW + kF * kLdW,       // [F][kLdW] the carry dW
  kOffXQ = kOffDW + kF * kLdW,      // [CS][kLdX] bf16(XQ)
  kOffXK = kOffXQ + kCS * kLdX,     // [CS][kLdX] bf16(XK)
  kOffZ = kOffXK + kCS * kLdX,      // [CS][kLdX] Z1, then Zb1
  kOffQW = kOffZ + kCS * kLdX,      // [CS][kLdX] XQ @ bf16(W)
  kOffG = kOffQW + kCS * kLdX,      // [CS][kLdX] Gs
  kOffDZ = kOffG + kCS * kLdX,      // [CS][kLdX] dZb1, then dZ1 (fp32)
  kOffDZC = kOffDZ + kCS * kLdX,    // [CS][kLdX] the same, rounded to bf16
  kOffDXQ = kOffDZC + kCS * kLdX,   // [CS][kLdX] dXQ before the rope / L2-norm VJP
  kOffDXK = kOffDXQ + kCS * kLdX,   // [CS][kLdX] dXK before the rope / L2-norm VJP
  kOffDG = kOffDXK + kCS * kLdX,    // [CS][kLdX] dG
  kOffA = kOffDG + kCS * kLdX,      // [CS][CS] bf16(A1)
  kOffDA = kOffA + kCS * kCS,       // [CS][CS] bf16(dA1)
  kSmemFloats = kOffDA + kCS * kCS,
};
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");
static_assert(kOffXQ % 4 == 0 && kOffXK % 4 == 0 && kOffZ % 4 == 0 && kOffQW % 4 == 0 && kOffG % 4 == 0 &&
              kOffDZ % 4 == 0 && kOffDZC % 4 == 0 && kOffDXQ % 4 == 0 && kOffDXK % 4 == 0 && kOffDG % 4 == 0,
              "float4 alignment");

__global__ void __launch_bounds__(kThreads, 1)
ttt_linear_bwd_kernel(ScanArgs a, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      const float* __restrict__ w_ck, const float* __restrict__ b_ck,
                      const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dxq,
                      __nv_bfloat16* __restrict__ dxk, __nv_bfloat16* __restrict__ dxv, float* __restrict__ dgate,
                      float* __restrict__ dW, float* __restrict__ db, float* __restrict__ dlnw,
                      float* __restrict__ dlnb, __nv_bfloat16* __restrict__ stash_w, float* __restrict__ stash_b,
                      int K) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem + kOffW;
  float* sDW = smem + kOffDW;
  float* sXQ = smem + kOffXQ;
  float* sXK = smem + kOffXK;
  float* sZ = smem + kOffZ;
  float* sQW = smem + kOffQW;
  float* sG = smem + kOffG;
  float* sDZ = smem + kOffDZ;
  float* sDZC = smem + kOffDZC;
  float* sDXQ = smem + kOffDXQ;
  float* sDXK = smem + kOffDXK;
  float* sDG = smem + kOffDG;
  float* sA = smem + kOffA;
  float* sDA = smem + kOffDA;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int c = tid & (kF - 1), r0 = (tid >> 6) * 4, k0 = tid >> 6;  // column c; rows r0..r0+3; W rows k0 + 4j
  const int f0 = 2 * lane;
  const int ar = tid >> 4, ac = tid & (kCS - 1);  // one element of a [CS][CS] tile
  const int NG = (a.NC + K - 1) / K;
  const size_t HF = (size_t)a.H * kF;
  __nv_bfloat16* SW = stash_w + (size_t)bh * K * kF * kF;
  float* SB = stash_b + (size_t)bh * K * kF;

  const float2 lw = make_float2(ln_w[(size_t)h * kF + f0], ln_w[(size_t)h * kF + f0 + 1]);
  const float2 lb = make_float2(ln_b[(size_t)h * kF + f0], ln_b[(size_t)h * kF + f0 + 1]);
  for (int i = tid; i < kF * kLdW; i += kThreads) sDW[i] = 0.f;
  float dbc = 0.f;                                   // the bias carry db[c]
  float2 acc_w = make_float2(0.f, 0.f), acc_b = acc_w;  // dln_w / dln_b over this lane's rows
  __syncthreads();

  for (int g = NG - 1; g >= 0; --g) {
    const int n0 = g * K, valid = min(K, a.NC - n0);

    // ---------------- Pass A: the forward from checkpoint g, stashing each step's state.
    const size_t ck = (size_t)bh * NG + g;
    for (int i = tid; i < kF * kF; i += kThreads) sW[(i / kF) * kLdW + i % kF] = w_ck[ck * kF * kF + i];
    float bc = b_ck[ck * kF + c];
    __syncthreads();
    for (int i = 0; i < valid; ++i) {
      for (int e = tid; e < kF * kF; e += kThreads) SW[(size_t)i * kF * kF + e] = __float2bfloat16(sW[(e / kF) * kLdW + e % kF]);
      if (r0 == 0) SB[(size_t)i * kF + c] = bc;
      float2 tgt[2];
      float eta[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        const Row p = preproc(a, b, h, n0 + i, r, f0, lw, lb);
        tgt[rr] = p.tgt;
        eta[rr] = p.eta;
        sXK[r * kLdX + f0] = bf16r(p.XK.x);
        sXK[r * kLdX + f0 + 1] = bf16r(p.XK.y);
      }
      __syncthreads();
      {  // Z1 = XK @ bf16(W) + b
        float z[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < kF; ++k) {
          const float w = bf16r(sW[k * kLdW + c]);
#pragma unroll
          for (int j = 0; j < 4; ++j) z[j] += sXK[(r0 + j) * kLdX + k] * w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sZ[(r0 + j) * kLdX + c] = z[j] + bc;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {  // Gs = bf16(eta * ln_fused_l2_bwd(Z1, target))
        const int r = warp * 2 + rr;
        const float2 gr = fused_l2_grad(make_float2(sZ[r * kLdX + f0], sZ[r * kLdX + f0 + 1]), tgt[rr], lw, lb);
        sG[r * kLdX + f0] = bf16r(eta[rr] * gr.x);
        sG[r * kLdX + f0 + 1] = bf16r(eta[rr] * gr.y);
      }
      __syncthreads();
      {  // b -= colsum(Gs); W -= XK^T @ Gs
        float gc[kCS];
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) {
          gc[r] = sG[r * kLdX + c];
          cs += gc[r];
        }
        bc -= cs;
        for (int k = k0; k < kF; k += 4) {
          float d = 0.f;
#pragma unroll
          for (int r = 0; r < kCS; ++r) d += sXK[r * kLdX + k] * gc[r];
          sW[k * kLdW + c] -= d;
        }
      }
      __syncthreads();
    }

    // ---------------- Pass B: the step VJP, last step first.
    for (int j = valid - 1; j >= 0; --j) {
      const int n = n0 + j;
      // P0: the stashed state; preprocessing, kept per lane.
      for (int e = tid; e < kF * kF; e += kThreads)
        sW[(e / kF) * kLdW + e % kF] = __bfloat162float(SW[(size_t)j * kF * kF + e]);
      const float bc = SB[(size_t)j * kF + c];
      Row p[2];
      float2 dO[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        p[rr] = preproc(a, b, h, n, r, f0, lw, lb);
        sXQ[r * kLdX + f0] = bf16r(p[rr].XQ.x);
        sXQ[r * kLdX + f0 + 1] = bf16r(p[rr].XQ.y);
        sXK[r * kLdX + f0] = bf16r(p[rr].XK.x);
        sXK[r * kLdX + f0 + 1] = bf16r(p[rr].XK.y);
        const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
        dO[rr] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + xo));
      }
      __syncthreads();

      // P1: Z1 = XK @ W + b, XQ @ W (W is bf16-valued); A1 = bf16(XQ @ XK^T).
      {
        float z[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < kF; ++k) {
          const float w = sW[k * kLdW + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            z[i] += sXK[(r0 + i) * kLdX + k] * w;
            q[i] += sXQ[(r0 + i) * kLdX + k] * w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sZ[(r0 + i) * kLdX + c] = z[i] + bc;
          sQW[(r0 + i) * kLdX + c] = q[i];
        }
        float s = 0.f;
        for (int k = 0; k < kF; k += 4) {
          const float4 x = ld4(sXQ + ar * kLdX + k), y = ld4(sXK + ac * kLdX + k);
          s += x.x * y.x;
          s += x.y * y.y;
          s += x.z * y.z;
          s += x.w * y.w;
        }
        sA[ar * kCS + ac] = bf16r(s);
      }
      __syncthreads();

      // P2: z1_hat, std1 = ln_stats(Z1); g1 = ln_fused_l2(z1_hat, std1, target); Gs = bf16(eta * g1).
      float2 zh[2], g1[2];
      float sd1[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        zh[rr] = ln_stats(make_float2(sZ[r * kLdX + f0], sZ[r * kLdX + f0 + 1]), sd1[rr]);
        const float gx0 = lw.x * ((lw.x * zh[rr].x + lb.x) - p[rr].tgt.x);
        const float gx1 = lw.y * ((lw.y * zh[rr].y + lb.y) - p[rr].tgt.y);
        const float m2 = warp_sum(gx0 * zh[rr].x + gx1 * zh[rr].y) * (1.f / kF);
        const float m1 = warp_sum(gx0 + gx1) * (1.f / kF);
        g1[rr] = make_float2((gx0 - m1 - zh[rr].x * m2) / sd1[rr], (gx1 - m1 - zh[rr].y * m2) / sd1[rr]);
        sG[r * kLdX + f0] = bf16r(p[rr].eta * g1[rr].x);
        sG[r * kLdX + f0 + 1] = bf16r(p[rr].eta * g1[rr].y);
      }
      __syncthreads();

      // P3: Zb1 = XQ @ W - A1 @ Gs + b - colsum(Gs).
      {
        float gc[kCS];
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) {
          gc[r] = sG[r * kLdX + c];
          cs += gc[r];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float ag = 0.f;
#pragma unroll
          for (int s = 0; s < kCS; ++s) ag += sA[(r0 + i) * kCS + s] * gc[s];
          sZ[(r0 + i) * kLdX + c] = ((sQW[(r0 + i) * kLdX + c] - ag) + bc) - cs;
        }
      }
      __syncthreads();

      // P4: out = XQ + LN(Zb1): dZb1 and the LN-affine cotangents; dXQ starts at dout.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        float sd;
        const float2 xh = ln_stats(make_float2(sZ[r * kLdX + f0], sZ[r * kLdX + f0 + 1]), sd);
        const float w0 = lw.x * dO[rr].x, w1 = lw.y * dO[rr].y;
        const float mw = warp_sum(w0 + w1) * (1.f / kF);
        const float mwx = warp_sum(w0 * xh.x + w1 * xh.y) * (1.f / kF);
        const float d0 = (w0 - mw - xh.x * mwx) / sd, d1 = (w1 - mw - xh.y * mwx) / sd;
        acc_w.x += dO[rr].x * xh.x;
        acc_w.y += dO[rr].y * xh.y;
        acc_b.x += dO[rr].x;
        acc_b.y += dO[rr].y;
        sDZ[r * kLdX + f0] = d0;
        sDZ[r * kLdX + f0 + 1] = d1;
        sDZC[r * kLdX + f0] = bf16r(d0);
        sDZC[r * kLdX + f0 + 1] = bf16r(d1);
        sDXQ[r * kLdX + f0] = dO[rr].x;
        sDXQ[r * kLdX + f0 + 1] = dO[rr].y;
      }
      __syncthreads();

      // P5: dXQ += dZb1c @ W^T; dG = -A1^T @ dZb1c - db_tot - XK @ bf16(dW); dXK = -Gs @ bf16(dW)^T;
      //     this step's dW starts at XQ^T @ dZb1c; dA1 = bf16(-dZb1c @ Gs^T).
      float dws[kF / 4];
      float dbt;
      {
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) cs += sDZ[r * kLdX + c];
        dbt = dbc + cs;
        float xq[4] = {0.f, 0.f, 0.f, 0.f}, xk[4] = {0.f, 0.f, 0.f, 0.f}, dg[4] = {0.f, 0.f, 0.f, 0.f};
        float dgw[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < kF; ++k) {
          const float wck = sW[c * kLdW + k];               // W[c][k]
          const float dwck = bf16r(sDW[c * kLdW + k]);      // bf16(dW)[c][k]
          const float dwkc = bf16r(sDW[k * kLdW + c]);      // bf16(dW)[k][c]
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xq[i] += sDZC[(r0 + i) * kLdX + k] * wck;
            xk[i] += sG[(r0 + i) * kLdX + k] * dwck;
            dgw[i] += sXK[(r0 + i) * kLdX + k] * dwkc;
          }
        }
        for (int s = 0; s < kCS; ++s) {
          const float dz = sDZC[s * kLdX + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dg[i] += sA[s * kCS + r0 + i] * dz;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sDXQ[(r0 + i) * kLdX + c] += xq[i];
          sDG[(r0 + i) * kLdX + c] = (-dg[i] - dbt) - dgw[i];
          sDXK[(r0 + i) * kLdX + c] = -xk[i];
        }
#pragma unroll
        for (int jj = 0; jj < kF / 4; ++jj) {
          const int k = k0 + 4 * jj;
          float d = 0.f;
#pragma unroll
          for (int r = 0; r < kCS; ++r) d += sXQ[r * kLdX + k] * sDZC[r * kLdX + c];
          dws[jj] = d;
        }
        float s = 0.f;
        for (int k = 0; k < kF; k += 4) {
          const float4 x = ld4(sDZC + ar * kLdX + k), y = ld4(sG + ac * kLdX + k);
          s += x.x * y.x;
          s += x.y * y.y;
          s += x.z * y.z;
          s += x.w * y.w;
        }
        sDA[ar * kCS + ac] = bf16r(-s);
      }
      __syncthreads();

      // P6: dXQ += dA1c @ XK; dXK += dA1c^T @ XQ.
      {
        float xq[4] = {0.f, 0.f, 0.f, 0.f}, xk[4] = {0.f, 0.f, 0.f, 0.f};
        for (int s = 0; s < kCS; ++s) {
          const float vk = sXK[s * kLdX + c], vq = sXQ[s * kLdX + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            xq[i] += sDA[(r0 + i) * kCS + s] * vk;
            xk[i] += sDA[s * kCS + r0 + i] * vq;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sDXQ[(r0 + i) * kLdX + c] += xq[i];
          sDXK[(r0 + i) * kLdX + c] += xk[i];
        }
      }
      __syncthreads();

      // P7: Gs = eta * g1: de, dg1; g1 = ln_fused_l2(Z1, target): dZ1, dtarget; target = LN(XV - XK): dXV;
      //     d_gate = de * eta * (1 - sigmoid).
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        const float2 dG = make_float2(sDG[r * kLdX + f0], sDG[r * kLdX + f0 + 1]);
        const float de = warp_sum(dG.x * g1[rr].x + dG.y * g1[rr].y);
        const float u0 = p[rr].eta * dG.x, u1 = p[rr].eta * dG.y;
        const float2 xh = zh[rr], t = p[rr].tgt;
        const float sd = sd1[rr];
        const float y0 = lw.x * xh.x + lb.x, y1 = lw.y * xh.y + lb.y;
        const float gx0 = lw.x * (y0 - t.x), gx1 = lw.y * (y1 - t.y);
        const float m2 = warp_sum(gx0 * xh.x + gx1 * xh.y) * (1.f / kF);
        const float mu_ = warp_sum(u0 + u1) * (1.f / kF);
        const float mux = warp_sum(u0 * xh.x + u1 * xh.y) * (1.f / kF);
        const float dgx0 = (u0 - mu_ - xh.x * mux) / sd, dgx1 = (u1 - mu_ - xh.y * mux) / sd;
        const float dxh0 = -(m2 * u0 + gx0 * mux) / sd + lw.x * lw.x * dgx0;
        const float dxh1 = -(m2 * u1 + gx1 * mux) / sd + lw.y * lw.y * dgx1;
        const float dstd = -warp_sum(u0 * g1[rr].x + u1 * g1[rr].y) / sd;
        const float mdx = warp_sum(dxh0 + dxh1) * (1.f / kF);
        const float mdxx = warp_sum(dxh0 * xh.x + dxh1 * xh.y) * (1.f / kF);
        const float dz0 = (dxh0 - mdx - xh.x * mdxx) / sd + dstd * xh.x / kF;
        const float dz1 = (dxh1 - mdx - xh.y * mdxx) / sd + dstd * xh.y / kF;
        const float dt0 = -lw.x * dgx0, dt1 = -lw.y * dgx1;
        acc_w.x += dgx0 * (y0 - t.x) + dgx0 * lw.x * xh.x;
        acc_w.y += dgx1 * (y1 - t.y) + dgx1 * lw.y * xh.y;
        acc_b.x += dgx0 * lw.x;
        acc_b.y += dgx1 * lw.y;
        // target = lnw * t_hat + lnb, t_hat = (t - mu) / s, s = sqrt(unbiased var) + eps.
        const float gg0 = lw.x * dt0, gg1 = lw.y * dt1;
        const float mg = warp_sum(gg0 + gg1) * (1.f / kF);
        const float sgt = warp_sum(gg0 * p[rr].that.x + gg1 * p[rr].that.y);
        const float sqrtv = fmaxf(p[rr].sd - 1e-8f, 1e-20f);
        const float dv0 = (gg0 - mg) / p[rr].sd - p[rr].that.x * (sgt / ((kF - 1) * sqrtv));
        const float dv1 = (gg1 - mg) / p[rr].sd - p[rr].that.y * (sgt / ((kF - 1) * sqrtv));
        acc_w.x += dt0 * p[rr].that.x;
        acc_w.y += dt1 * p[rr].that.y;
        acc_b.x += dt0;
        acc_b.y += dt1;
        sDXK[r * kLdX + f0] -= dv0;
        sDXK[r * kLdX + f0 + 1] -= dv1;
        sDZ[r * kLdX + f0] = dz0;
        sDZ[r * kLdX + f0 + 1] = dz1;
        sDZC[r * kLdX + f0] = bf16r(dz0);
        sDZC[r * kLdX + f0 + 1] = bf16r(dz1);
        const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
        *reinterpret_cast<__nv_bfloat162*>(dxv + xo) = __floats2bfloat162_rn(dv0, dv1);
        if (lane == 0)
          dgate[(((size_t)b * a.H + h) * a.NC + n) * kCS + r] = de * p[rr].eta * (1.f - p[rr].sig);
      }
      __syncthreads();

      // P8: dXK += dZ1c @ W^T; db = db_tot + colsum(dZ1); dW = (XQ^T @ dZb1c + dW) + XK^T @ dZ1c.
      {
        float xk[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < kF; ++k) {
          const float wck = sW[c * kLdW + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) xk[i] += sDZC[(r0 + i) * kLdX + k] * wck;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sDXK[(r0 + i) * kLdX + c] += xk[i];
        float cs = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) cs += sDZ[r * kLdX + c];
        dbc = dbt + cs;
#pragma unroll
        for (int jj = 0; jj < kF / 4; ++jj) {
          const int k = k0 + 4 * jj;
          float d = 0.f;
#pragma unroll
          for (int r = 0; r < kCS; ++r) d += sXK[r * kLdX + k] * sDZC[r * kLdX + c];
          sDW[k * kLdW + c] = (dws[jj] + sDW[k * kLdW + c]) + d;
        }
      }
      __syncthreads();

      // P9: rope and L2-norm VJPs back to the raw projections.
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = warp * 2 + rr;
        const Row& q = p[rr];
        const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
        const float2 us[2] = {make_float2(sDXQ[r * kLdX + f0], sDXQ[r * kLdX + f0 + 1]),
                              make_float2(sDXK[r * kLdX + f0], sDXK[r * kLdX + f0 + 1])};
        const float2 xs[2] = {q.q, q.k};
        __nv_bfloat16* outs[2] = {dxq, dxk};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          // rope VJP: u*cos - pair_swap(u)*sin, pair_swap(u) = (-u1, u0).
          const float v0 = us[t].x * q.c.x + us[t].y * q.s.x, v1 = us[t].y * q.c.y - us[t].x * q.s.y;
          const float2 x = xs[t];
          const float nrm = sqrtf(warp_sum(x.x * x.x + x.y * x.y));
          const float m = fmaxf(nrm, 1e-12f);
          const float proj = warp_sum(v0 * x.x + v1 * x.y);
          const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(outs[t] + xo) = __floats2bfloat162_rn(v0 / m - x.x * corr, v1 / m - x.y * corr);
        }
      }
      __syncthreads();
    }
  }

  // Outputs: dW, db, and dln_w / dln_b reduced over the warps.
  for (int i = tid; i < kF * kF; i += kThreads) dW[(size_t)bh * kF * kF + i] = sDW[(i / kF) * kLdW + i % kF];
  if (r0 == 0) db[(size_t)bh * kF + c] = dbc;
  float* red = sZ;  // [2][8][F]
  red[warp * kF + f0] = acc_w.x;
  red[warp * kF + f0 + 1] = acc_w.y;
  red[8 * kF + warp * kF + f0] = acc_b.x;
  red[8 * kF + warp * kF + f0 + 1] = acc_b.y;
  __syncthreads();
  if (tid < kF) {
    float sw = 0.f, sb = 0.f;
    for (int w = 0; w < 8; ++w) {
      sw += red[w * kF + tid];
      sb += red[8 * kF + w * kF + tid];
    }
    dlnw[(size_t)bh * kF + tid] = sw;
    dlnb[(size_t)bh * kF + tid] = sb;
  }
}

}  // namespace

extern "C" int ttt_linear_backward_smem_bytes() { return kSmemBytes; }

extern "C" int ttt_linear_backward(const void* xq, const void* xk, const void* xv, const void* gate,
                                   const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                   const void* w_ck, const void* b_ck, const void* dout, void* dxq, void* dxk,
                                   void* dxv, void* dgate, void* dW, void* db, void* dlnw, void* dlnb, void* stash_w,
                                   void* stash_b, int B, int NC, int H, int K, float eta_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(ttt_linear_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ScanArgs a{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                   static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                   static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), NC, H, eta_scale};
  ttt_linear_bwd_kernel<<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(w_ck),
      static_cast<const float*>(b_ck), static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dxq),
      static_cast<__nv_bfloat16*>(dxk), static_cast<__nv_bfloat16*>(dxv), static_cast<float*>(dgate),
      static_cast<float*>(dW), static_cast<float*>(db), static_cast<float*>(dlnw), static_cast<float*>(dlnb),
      static_cast<__nv_bfloat16*>(stash_w), static_cast<float*>(stash_b), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
