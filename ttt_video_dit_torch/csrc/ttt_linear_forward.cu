// Fused TTT-linear forward scan (K5), head_dim F = 64, mini-batch CS = 16,
// for Hopper (sm_90a): sampling (no state checkpoints) and training (fp32
// state checkpoints every K mini-batches, for csrc/ttt_linear_backward.cu).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_linear_kernel with
// _fused_preproc and _eta_from_gate (launched by ttt_linear_forward, reached
// through ttt_vjp.py:ttt_linear_fused_pre and ttt_linear_kernel.py:
// ttt_linear), in its token-major, fused-preprocessing form. Per (batch,
// head) it walks the NC mini-batches in order: L2-norm + rope of the raw
// q/k projections, the LN-reconstruction target from v - k, eta =
// sigmoid(gate) * eta_scale, one dual-form update of the linear fast weight
// (W [F, F], b [F]; fp32 state), and out = XQ + LN(Z1_bar).
//
// What bounds it on the H100: the scan is sequential in NC, so one block
// owns one (batch, head) and the limit is the latency of one step inside an
// SM: ~0.3 MFLOP of 16-row products against the 16 KiB fp32 state and five
// block-wide barriers per step. Device memory is not the limit (a step reads
// ~6 KiB of inputs and writes 2 KiB; the whole call moves ~0.9 GB at the
// 3 s sampling shape, 0.27 ms at 3.35 TB/s). At B = 2 the grid is 96 blocks
// on 132 SMs, at B = 1 (training) 48.
//
// Design: the fp32 state lives in shared memory for the whole scan (38 KB
// with the step tiles, static). Products are fp32 FMAs on operands rounded to
// bf16 exactly where _linear_kernel rounds them (XQ/XK after preprocessing,
// W.astype(dt) for Z1 and XQ @ W, the eta-scaled gradient Gs, attn), so each
// product is exact and only the fp32 summation order differs from the Pallas
// kernel and from the plain version. A thread owns one column c of the
// [CS][F] tiles over four rows, and of W over 16 rows: it computes Z1 and
// XQ @ W before the state moves, so the W update needs no barrier of its own;
// the four threads of a column keep identical copies of b[c] in a register.
// Row-wise work (preprocessing, the LN gradient, the output LN) is a warp per
// two rows (ttt_linear_block.cuh). Before mini-batch n with n % K == 0 the
// training launch writes the state (W, and b as one row, not the TPU's
// 8 rows x 0.125) as checkpoint n / K; the last group may be shorter than K.
// Not yet done: tensor cores, prefetching the next step's inputs, more than
// one scan per SM.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*F] bf16 (head h = columns h*F..h*F+F);
// gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope cos/sin [NC, CS, F] f32;
// ln_w/ln_b [H, F] f32; W1 [H, F, F], b1 [H, 1, F] f32 (the initial state,
// shared by every batch element); checkpoints W1 [B, H, NG, F, F], b1
// [B, H, NG, 1, F] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ttt_linear_block.cuh"

namespace {

using namespace tttl;

__global__ void __launch_bounds__(kThreads)
ttt_linear_fwd_kernel(ScanArgs a, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                      const float* __restrict__ W1, const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ w_ck, float* __restrict__ b_ck, int K) {
  __shared__ __align__(16) float sW[kF * kF];
  __shared__ __align__(16) float sXQ[kCS * kLdX];  // bf16-rounded XQ
  __shared__ __align__(16) float sXK[kCS * kLdX];  // bf16-rounded XK
  __shared__ __align__(16) float sG[kCS * kLdX];   // Gs = bf16(eta * grad)
  __shared__ __align__(16) float sZ[kCS * kF];     // Z1, then Z1_bar
  __shared__ __align__(16) float sQW[kCS * kF];    // XQ @ bf16(W)
  __shared__ float sA[kCS * kCS];                  // bf16(attn)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int c = tid & (kF - 1), r0 = (tid >> 6) * 4;  // column-thread: column c, rows r0..r0+3 (W rows tid>>6 + 4j)
  const int f0 = 2 * lane;
  const int NG = K > 0 ? (a.NC + K - 1) / K : 0;

  for (int i = tid; i < kF * kF; i += kThreads) sW[i] = W1[(size_t)h * kF * kF + i];
  float bc = b1[(size_t)h * kF + c];
  const float2 lw = make_float2(ln_w[(size_t)h * kF + f0], ln_w[(size_t)h * kF + f0 + 1]);
  const float2 lb = make_float2(ln_b[(size_t)h * kF + f0], ln_b[(size_t)h * kF + f0 + 1]);
  __syncthreads();

  for (int n = 0; n < a.NC; ++n) {
    if (K > 0 && n % K == 0) {
      const size_t g = (size_t)bh * NG + n / K;
      for (int i = tid; i < kF * kF; i += kThreads) w_ck[g * kF * kF + i] = sW[i];
      if (r0 == 0) b_ck[g * kF + c] = bc;
    }

    // ---- A: preprocessing (row-wise); keep the target and eta in registers.
    float2 tgt[2];
    float eta[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const Row p = preproc(a, b, h, n, r, f0, lw, lb);
      tgt[rr] = p.tgt;
      eta[rr] = p.eta;
      sXQ[r * kLdX + f0] = bf16r(p.XQ.x);
      sXQ[r * kLdX + f0 + 1] = bf16r(p.XQ.y);
      sXK[r * kLdX + f0] = bf16r(p.XK.x);
      sXK[r * kLdX + f0 + 1] = bf16r(p.XK.y);
    }
    __syncthreads();

    // ---- B: Z1 = XK @ bf16(W) + b and XQ @ bf16(W) (column c, rows r0..r0+3); attn = bf16(XQ @ XK^T).
    {
      float z[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < kF; k += 4) {
        const float w0 = bf16r(sW[(k + 0) * kF + c]), w1 = bf16r(sW[(k + 1) * kF + c]);
        const float w2 = bf16r(sW[(k + 2) * kF + c]), w3 = bf16r(sW[(k + 3) * kF + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(sXK + (r0 + i) * kLdX + k), y = ld4(sXQ + (r0 + i) * kLdX + k);
          z[i] += x.x * w0;
          z[i] += x.y * w1;
          z[i] += x.z * w2;
          z[i] += x.w * w3;
          q[i] += y.x * w0;
          q[i] += y.y * w1;
          q[i] += y.z * w2;
          q[i] += y.w * w3;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sZ[(r0 + i) * kF + c] = z[i] + bc;
        sQW[(r0 + i) * kF + c] = q[i];
      }
      const int ar = tid >> 4, ac = tid & (kCS - 1);
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

    // ---- C: Gs = bf16(eta * ln_fused_l2_bwd(Z1, target)) (row-wise).
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const float2 g = fused_l2_grad(make_float2(sZ[r * kF + f0], sZ[r * kF + f0 + 1]), tgt[rr], lw, lb);
      sG[r * kLdX + f0] = bf16r(eta[rr] * g.x);
      sG[r * kLdX + f0 + 1] = bf16r(eta[rr] * g.y);
    }
    __syncthreads();

    // ---- D: b -= colsum(Gs); Z1_bar = XQ @ bf16(W) - attn @ Gs + b (rows r0..r0+3);
    //         W -= XK^T @ Gs (rows tid>>6 + 4j of column c).
    {
      float g[kCS];
      float cs = 0.f;
#pragma unroll
      for (int r = 0; r < kCS; ++r) {
        g[r] = sG[r * kLdX + c];
        cs += g[r];
      }
      bc -= cs;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ag = 0.f;
#pragma unroll
        for (int s = 0; s < kCS; ++s) ag += sA[(r0 + i) * kCS + s] * g[s];
        sZ[(r0 + i) * kF + c] = (sQW[(r0 + i) * kF + c] - ag) + bc;
      }
      for (int k = tid >> 6; k < kF; k += 4) {
        float d = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) d += sXK[r * kLdX + k] * g[r];
        sW[k * kF + c] -= d;
      }
    }
    __syncthreads();

    // ---- E: out = XQ + LN(Z1_bar) (row-wise, eps 1e-8 on the biased variance).
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      float sd;
      const float2 xh = ln_stats(make_float2(sZ[r * kF + f0], sZ[r * kF + f0 + 1]), sd);
      const float o0 = sXQ[r * kLdX + f0] + (lw.x * xh.x + lb.x);
      const float o1 = sXQ[r * kLdX + f0 + 1] + (lw.y * xh.y + lb.y);
      const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * ((size_t)a.H * kF) + (size_t)h * kF + f0;
      *reinterpret_cast<__nv_bfloat162*>(out + xo) = __floats2bfloat162_rn(o0, o1);
    }
    __syncthreads();
  }
}

}  // namespace

// K = 0: sampling, no checkpoints (w_ck and b_ck unused).
extern "C" int ttt_linear_forward(const void* xq, const void* xk, const void* xv, const void* gate,
                                  const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                  const void* W1, const void* b1, void* out, void* w_ck, void* b_ck, int B, int NC,
                                  int H, int K, float eta_scale, void* stream) {
  const ScanArgs a{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                   static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                   static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), NC, H, eta_scale};
  ttt_linear_fwd_kernel<<<B * H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
      static_cast<const float*>(b1), static_cast<__nv_bfloat16*>(out), static_cast<float*>(w_ck),
      static_cast<float*>(b_ck), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
