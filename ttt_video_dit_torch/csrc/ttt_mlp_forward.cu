// Fused TTT-MLP forward scan, head_dim F = 64, for Hopper (sm_90a): the
// sampling kernel (mini-batch CS = 16, no state checkpoints) and, at the end
// of this file, the training kernel (CS = 64, fp32 state checkpoints every K
// mini-batches for the backward, csrc/ttt_mlp_backward.cu).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_mlp_kernel with
// _fused_preproc and _eta_from_gate (launched by ttt_mlp_forward, reached
// through ttt_vjp.py:ttt_mlp_fused_pre and ttt_mlp_kernel.py:ttt_mlp), in its
// token-major, fused-preprocessing form. Per (batch, head) it walks the NC
// mini-batches in order: L2-norm + rope of the raw q/k projections, the
// LN-reconstruction target from v - k, eta = sigmoid(gate) * eta_scale, one
// dual-form update of the two-layer GELU fast-weight MLP (W1 [F,4F], b1,
// W2 [4F,F], b2; fp32 state), and out = XQ + LN(Z2_bar).
//
// What bounds it on the H100: the scan is sequential in NC, so one block owns
// one (batch, head) scan and the limit is the latency of one mini-batch step
// inside an SM. Each step does ~4 Mflop of small (16-row) products against
// 128 KiB of fp32 state, so it is bound by shared-memory bandwidth and by the
// ~10 block-wide barriers per step, not by device memory (the step reads
// ~6 KiB of inputs and writes 2 KiB). At B = 2 the grid is 96 blocks on 132
// SMs: a third of the card idles.
//
// Design: the fp32 state (W1, W2, b1, b2) lives in dynamic shared memory for
// the whole scan (~205 KiB with the step tiles, under the 227 KB opt-in set
// with cudaFuncSetAttribute); it never round-trips device memory between
// mini-batches. Products use fp32 FMAs on operands rounded to bf16 exactly
// where _mlp_kernel rounds them (XQ/XK after preprocessing, every
// W.astype(dt), X2c, G1, G2, attn1, attn2, X2_barc, bf16(grad_z2)), so each
// product is exact and only the fp32 summation order differs from the Pallas
// kernel and from the plain version. Thread-to-data maps keep every column of
// W1 with one thread (Z1, Z1_bar and the W1 update need no barrier between
// them), and the padded row strides (W2: 65, X2c: 260, XQ/XK: 68 floats)
// keep the strided reads free of bank conflicts or at most 2-way.
// The sampling kernel writes no state checkpoints. Not yet done: tensor
// cores (mma.sync on the bf16 operands), prefetching the next step's inputs,
// more than one scan per SM.
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*F] bf16 (head h = columns h*F..h*F+F);
// gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope cos/sin [NC, CS, F] f32
// (interleaved, identity rows on text slots); ln_w/ln_b [H, F] f32;
// W1 [H, F, 4F], b1 [H, 1, 4F], W2 [H, 4F, F], b2 [H, 1, F] f32 (the initial
// state, shared by every batch element).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ttt_mlp_block.cuh"

namespace {

constexpr int kF = 64;
constexpr int kF4 = 4 * kF;
constexpr int kCS = 16;
constexpr int kThreads = 256;  // 8 warps; one thread per column of W1
constexpr int kLdW2 = kF + 1;  // W2 row stride: thread j reads row j conflict-free
constexpr int kLdX = kF + 4;   // XQ / XK row stride (16-byte aligned rows)
constexpr int kLdX2 = kF4 + 4; // X2c row stride (16-byte aligned rows)

// Shared-memory carve-up, in floats.
constexpr int kOffW1 = 0;                        // [F][4F]
constexpr int kOffW2 = kOffW1 + kF * kF4;        // [4F][kLdW2]
constexpr int kOffB1 = kOffW2 + kF4 * kLdW2;     // [4F]
constexpr int kOffB2 = kOffB1 + kF4;             // [F]
constexpr int kOffLnW = kOffB2 + kF;             // [F]
constexpr int kOffLnB = kOffLnW + kF;            // [F]
constexpr int kOffEta = kOffLnB + kF;            // [CS]
constexpr int kOffXQ = kOffEta + kCS;            // [CS][kLdX]   bf16-rounded XQ
constexpr int kOffXK = kOffXQ + kCS * kLdX;      // [CS][kLdX]   bf16-rounded XK
constexpr int kOffTgt = kOffXK + kCS * kLdX;     // [CS][F]      LN-reconstruction target
constexpr int kOffX2c = kOffTgt + kCS * kF;      // [CS][kLdX2]  bf16(gelu(Z1))
constexpr int kOffG1 = kOffX2c + kCS * kLdX2;    // [CS][4F]     gelu'(Z1), then G1
constexpr int kOffX2b = kOffG1 + kCS * kF4;      // [CS][4F]     bf16(gelu(Z1_bar))
constexpr int kOffZ2 = kOffX2b + kCS * kF4;      // [CS][F]      Z2, then Z2_bar
constexpr int kOffGz2 = kOffZ2 + kCS * kF;       // [CS][F]      bf16(grad_z2)
constexpr int kOffG2 = kOffGz2 + kCS * kF;       // [CS][F]      G2
constexpr int kOffA1 = kOffG2 + kCS * kF;        // [CS][CS]     bf16(attn1)
constexpr int kOffA2 = kOffA1 + kCS * kCS;       // [CS][CS]     bf16(attn2)
constexpr int kSmemFloats = kOffA2 + kCS * kCS;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");
static_assert(kOffXQ % 4 == 0 && kOffXK % 4 == 0 && kOffX2c % 4 == 0 && kOffX2b % 4 == 0 &&
              kOffGz2 % 4 == 0 && kOffA1 % 4 == 0 && kOffA2 % 4 == 0, "float4 alignment");

using tttb::bf16r;
using tttb::gelu_bwd;
using tttb::gelu_tanh;
using tttb::warp_sum;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__global__ void __launch_bounds__(kThreads, 1)
ttt_mlp_fwd_kernel(const __nv_bfloat16* __restrict__ xq, const __nv_bfloat16* __restrict__ xk,
                   const __nv_bfloat16* __restrict__ xv, const float* __restrict__ gate,
                   const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                   const float* __restrict__ W1, const float* __restrict__ b1,
                   const float* __restrict__ W2, const float* __restrict__ b2,
                   __nv_bfloat16* __restrict__ out, int NC, int H, float eta_scale) {
  extern __shared__ __align__(16) float smem[];
  float* sW1 = smem + kOffW1;
  float* sW2 = smem + kOffW2;
  float* sB1 = smem + kOffB1;
  float* sB2 = smem + kOffB2;
  float* sLnW = smem + kOffLnW;
  float* sLnB = smem + kOffLnB;
  float* sEta = smem + kOffEta;
  float* sXQ = smem + kOffXQ;
  float* sXK = smem + kOffXK;
  float* sTgt = smem + kOffTgt;
  float* sX2c = smem + kOffX2c;
  float* sG1 = smem + kOffG1;
  float* sX2b = smem + kOffX2b;
  float* sZ2 = smem + kOffZ2;
  float* sGz2 = smem + kOffGz2;
  float* sG2 = smem + kOffG2;
  float* sA1 = smem + kOffA1;
  float* sA2 = smem + kOffA2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t HF = (size_t)H * kF;

  // Initial state and LN affine for head h.
  for (int i = tid; i < kF * kF4; i += kThreads) sW1[i] = W1[(size_t)h * kF * kF4 + i];
  for (int i = tid; i < kF4 * kF; i += kThreads) sW2[(i / kF) * kLdW2 + i % kF] = W2[(size_t)h * kF4 * kF + i];
  sB1[tid] = b1[(size_t)h * kF4 + tid];
  if (tid < kF) {
    sB2[tid] = b2[(size_t)h * kF + tid];
    sLnW[tid] = ln_w[(size_t)h * kF + tid];
    sLnB[tid] = ln_b[(size_t)h * kF + tid];
  }
  __syncthreads();

  const int f0 = 2 * lane;  // the feature pair this lane owns in row-wise phases
  const float lw0 = sLnW[f0], lw1 = sLnW[f0 + 1], lb0 = sLnB[f0], lb1 = sLnB[f0 + 1];

  for (int n = 0; n < NC; ++n) {
    // ---- A: preprocessing. Warp w owns rows 2w, 2w+1; lane owns features f0, f0+1.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const size_t xo = (((size_t)b * NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
      const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xq + xo));
      const float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xk + xo));
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xv + xo));
      const size_t to = ((size_t)n * kCS + r) * kF + f0;
      const float2 c = *reinterpret_cast<const float2*>(rope_cos + to);
      const float2 s = *reinterpret_cast<const float2*>(rope_sin + to);

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
      sTgt[r * kF + f0] = lw0 * (d0 / sd) + lb0;
      sTgt[r * kF + f0 + 1] = lw1 * (d1 / sd) + lb1;
      sXQ[r * kLdX + f0] = bf16r(XQ0);
      sXQ[r * kLdX + f0 + 1] = bf16r(XQ1);
      sXK[r * kLdX + f0] = bf16r(XK0);
      sXK[r * kLdX + f0 + 1] = bf16r(XK1);
      if (lane == 0) {
        const float gl = gate[(((size_t)b * H + h) * NC + n) * kCS + r];
        sEta[r] = (1.f / (1.f + expf(-gl))) * eta_scale;
      }
    }
    __syncthreads();

    // ---- B: Z1 = XK @ bf16(W1) + b1 (thread = column c of 4F). Keep gelu'(Z1), bf16(gelu(Z1)).
    {
      const int c = tid;
      float acc[kCS];
#pragma unroll
      for (int r = 0; r < kCS; ++r) acc[r] = 0.f;
      for (int k = 0; k < kF; k += 4) {
        const float w0 = bf16r(sW1[(k + 0) * kF4 + c]), w1 = bf16r(sW1[(k + 1) * kF4 + c]);
        const float w2 = bf16r(sW1[(k + 2) * kF4 + c]), w3 = bf16r(sW1[(k + 3) * kF4 + c]);
#pragma unroll
        for (int r = 0; r < kCS; ++r) {
          const float4 x = ld4(sXK + r * kLdX + k);
          acc[r] += x.x * w0;
          acc[r] += x.y * w1;
          acc[r] += x.z * w2;
          acc[r] += x.w * w3;
        }
      }
      const float bias = sB1[c];
#pragma unroll
      for (int r = 0; r < kCS; ++r) {
        const float z = acc[r] + bias;
        sG1[r * kF4 + c] = gelu_bwd(z);
        sX2c[r * kLdX2 + c] = bf16r(gelu_tanh(z));
      }
    }
    __syncthreads();

    // ---- C: Z2 = X2c @ bf16(W2) + b2 (thread = column c of F, 4 rows).
    {
      const int c = tid & (kF - 1), r0 = (tid >> 6) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < kF4; k += 4) {
        const float w0 = bf16r(sW2[(k + 0) * kLdW2 + c]), w1 = bf16r(sW2[(k + 1) * kLdW2 + c]);
        const float w2 = bf16r(sW2[(k + 2) * kLdW2 + c]), w3 = bf16r(sW2[(k + 3) * kLdW2 + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(sX2c + (r0 + i) * kLdX2 + k);
          acc[i] += x.x * w0;
          acc[i] += x.y * w1;
          acc[i] += x.z * w2;
          acc[i] += x.w * w3;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sZ2[(r0 + i) * kF + c] = acc[i] + sB2[c];
    }
    __syncthreads();

    // ---- D: grad_z2 = ln_fused_l2_bwd(Z2, target) (row-wise; eps 1e-8 on the biased var).
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const float x0 = sZ2[r * kF + f0], x1 = sZ2[r * kF + f0 + 1];
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float xh0 = d0 / sd, xh1 = d1 / sd;
      const float gx0 = (lw0 * xh0 + lb0 - sTgt[r * kF + f0]) * lw0;
      const float gx1 = (lw1 * xh1 + lb1 - sTgt[r * kF + f0 + 1]) * lw1;
      const float s1 = warp_sum(gx0 + gx1);
      const float s2 = warp_sum(gx0 * xh0 + gx1 * xh1);
      const float g0 = (1.f / kF) * (kF * gx0 - s1 - xh0 * s2) / sd;
      const float g1 = (1.f / kF) * (kF * gx1 - s1 - xh1 * s2) / sd;
      const float eta = sEta[r];
      sGz2[r * kF + f0] = bf16r(g0);
      sGz2[r * kF + f0 + 1] = bf16r(g1);
      sG2[r * kF + f0] = bf16r(eta * g0);
      sG2[r * kF + f0 + 1] = bf16r(eta * g1);
    }
    __syncthreads();

    // ---- E: G1 = bf16(eta * (bf16(grad_z2) @ bf16(W2)^T * gelu'(Z1))) (thread = column j of 4F);
    //         attn1 = bf16(XQ @ XK^T).
    {
      const int j = tid;
      float acc[kCS];
#pragma unroll
      for (int r = 0; r < kCS; ++r) acc[r] = 0.f;
      for (int f = 0; f < kF; f += 4) {
        const float w0 = bf16r(sW2[j * kLdW2 + f + 0]), w1 = bf16r(sW2[j * kLdW2 + f + 1]);
        const float w2 = bf16r(sW2[j * kLdW2 + f + 2]), w3 = bf16r(sW2[j * kLdW2 + f + 3]);
#pragma unroll
        for (int r = 0; r < kCS; ++r) {
          const float4 gz = ld4(sGz2 + r * kF + f);
          acc[r] += gz.x * w0;
          acc[r] += gz.y * w1;
          acc[r] += gz.z * w2;
          acc[r] += gz.w * w3;
        }
      }
#pragma unroll
      for (int r = 0; r < kCS; ++r) sG1[r * kF4 + j] = bf16r(sEta[r] * (acc[r] * sG1[r * kF4 + j]));

      const int ar = tid >> 4, ac = tid & (kCS - 1);
      float a = 0.f;
      for (int k = 0; k < kF; k += 4) {
        const float4 x = ld4(sXQ + ar * kLdX + k), y = ld4(sXK + ac * kLdX + k);
        a += x.x * y.x;
        a += x.y * y.y;
        a += x.z * y.z;
        a += x.w * y.w;
      }
      sA1[ar * kCS + ac] = bf16r(a);
    }
    __syncthreads();

    // ---- F: per column c of 4F (one thread owns it): b1 -= colsum(G1);
    //         Z1_bar = XQ @ bf16(W1) - attn1 @ G1 + b1; X2_barc = bf16(gelu(Z1_bar));
    //         W1 -= XK^T @ G1.
    {
      const int c = tid;
      float g1[kCS];
      float colsum = 0.f;
#pragma unroll
      for (int r = 0; r < kCS; ++r) {
        g1[r] = sG1[r * kF4 + c];
        colsum += g1[r];
      }
      const float b1n = sB1[c] - colsum;
      sB1[c] = b1n;

      float acc[kCS];
#pragma unroll
      for (int r = 0; r < kCS; ++r) acc[r] = 0.f;
      for (int k = 0; k < kF; k += 4) {
        const float w0 = bf16r(sW1[(k + 0) * kF4 + c]), w1 = bf16r(sW1[(k + 1) * kF4 + c]);
        const float w2 = bf16r(sW1[(k + 2) * kF4 + c]), w3 = bf16r(sW1[(k + 3) * kF4 + c]);
#pragma unroll
        for (int r = 0; r < kCS; ++r) {
          const float4 x = ld4(sXQ + r * kLdX + k);
          acc[r] += x.x * w0;
          acc[r] += x.y * w1;
          acc[r] += x.z * w2;
          acc[r] += x.w * w3;
        }
      }
#pragma unroll
      for (int r = 0; r < kCS; ++r) {
        float ag = 0.f;
#pragma unroll
        for (int s = 0; s < kCS; ++s) ag += sA1[r * kCS + s] * g1[s];
        sX2b[r * kF4 + c] = bf16r(gelu_tanh((acc[r] - ag) + b1n));
      }
      for (int k = 0; k < kF; ++k) {
        float d = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) d += sXK[r * kLdX + k] * g1[r];
        sW1[k * kF4 + c] -= d;
      }
    }
    __syncthreads();

    // ---- G: attn2 = bf16(X2_barc @ X2c^T); b2 -= colsum(G2).
    {
      const int ar = tid >> 4, ac = tid & (kCS - 1);
      float a = 0.f;
      for (int k = 0; k < kF4; k += 4) {
        const float4 x = ld4(sX2b + ar * kF4 + k), y = ld4(sX2c + ac * kLdX2 + k);
        a += x.x * y.x;
        a += x.y * y.y;
        a += x.z * y.z;
        a += x.w * y.w;
      }
      sA2[ar * kCS + ac] = bf16r(a);
      if (tid < kF) {
        float colsum = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) colsum += sG2[r * kF + tid];
        sB2[tid] -= colsum;
      }
    }
    __syncthreads();

    // ---- H: Z2_bar = X2_barc @ bf16(W2) - attn2 @ G2 + b2 (thread = column c of F, 4 rows).
    {
      const int c = tid & (kF - 1), r0 = (tid >> 6) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < kF4; k += 4) {
        const float w0 = bf16r(sW2[(k + 0) * kLdW2 + c]), w1 = bf16r(sW2[(k + 1) * kLdW2 + c]);
        const float w2 = bf16r(sW2[(k + 2) * kLdW2 + c]), w3 = bf16r(sW2[(k + 3) * kLdW2 + c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 x = ld4(sX2b + (r0 + i) * kF4 + k);
          acc[i] += x.x * w0;
          acc[i] += x.y * w1;
          acc[i] += x.z * w2;
          acc[i] += x.w * w3;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ag = 0.f;
#pragma unroll
        for (int s = 0; s < kCS; ++s) ag += sA2[(r0 + i) * kCS + s] * sG2[s * kF + c];
        sZ2[(r0 + i) * kF + c] = (acc[i] - ag) + sB2[c];
      }
    }
    __syncthreads();

    // ---- I: W2 -= X2c^T @ G2 (thread = column c, rows j = jg, jg+4, ...);
    //         out = XQ + LN(Z2_bar) (row-wise, eps 1e-8 on the biased var).
    {
      const int c = tid & (kF - 1), jg = tid >> 6;
      float g2[kCS];
#pragma unroll
      for (int r = 0; r < kCS; ++r) g2[r] = sG2[r * kF + c];
      for (int j = jg; j < kF4; j += 4) {
        float d = 0.f;
#pragma unroll
        for (int r = 0; r < kCS; ++r) d += sX2c[r * kLdX2 + j] * g2[r];
        sW2[j * kLdW2 + c] -= d;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 2 + rr;
      const float x0 = sZ2[r * kF + f0], x1 = sZ2[r * kF + f0 + 1];
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float o0 = sXQ[r * kLdX + f0] + (lw0 * (d0 / sd) + lb0);
      const float o1 = sXQ[r * kLdX + f0 + 1] + (lw1 * (d1 / sd) + lb1);
      const size_t xo = (((size_t)b * NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
      *reinterpret_cast<__nv_bfloat162*>(out + xo) = __floats2bfloat162_rn(o0, o1);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int ttt_mlp_forward_smem_bytes() { return kSmemBytes; }

extern "C" int ttt_mlp_forward(const void* xq, const void* xk, const void* xv, const void* gate,
                               const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                               const void* W1, const void* b1, const void* W2, const void* b2, void* out,
                               int B, int NC, int H, float eta_scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(ttt_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ttt_mlp_fwd_kernel<<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
      static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
      static_cast<const float*>(b1), static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), NC, H, eta_scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- training
//
// ttt_mlp_fwd_train_kernel: the same scan at the training mini-batch
// CS = 64. At CS = 64 the fp32 step tiles alone are ~256 KiB, so the layout
// of the sampling kernel (state + tiles in shared memory) does not carry
// over: the state and the step tiles live in a per-block fp32 workspace in
// device memory (512 KiB per scan, L2-resident at 48 heads) and the step is
// the block-level forward_step of ttt_mlp_block.cuh, with the same bf16
// rounding points. Before mini-batch n with n % K == 0 it writes the fp32
// state (W1, b1, W2, b2, one bias row, not the TPU's 8 rows x 0.125) as
// checkpoint n / K; the last group may be shorter than K.

namespace {

struct TrainWork {  // per-(batch, head) fp32 workspace, in floats
  static constexpr int kW1 = 0, kW2 = kW1 + tttb::kState;
  static constexpr int kXQ = kW2 + tttb::kState, kXK = kXQ + tttb::kTile, kTG = kXK + tttb::kTile;
  static constexpr int kZ2 = kTG + tttb::kTile, kGZ2 = kZ2 + tttb::kTile, kG2 = kGZ2 + tttb::kTile;
  static constexpr int kA1 = kG2 + tttb::kTile, kA2 = kA1 + tttb::kTile;
  static constexpr int kZ1 = kA2 + tttb::kTile, kX2c = kZ1 + tttb::kWide, kG1 = kX2c + tttb::kWide;
  static constexpr int kX2b = kG1 + tttb::kWide;
  static constexpr int kFloats = kX2b + tttb::kWide;
};

__global__ void __launch_bounds__(tttb::kThreads, 1)
ttt_mlp_fwd_train_kernel(tttb::ScanArgs a, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                         const float* __restrict__ W1, const float* __restrict__ b1, const float* __restrict__ W2,
                         const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, float* __restrict__ w1_ck,
                         float* __restrict__ b1_ck, float* __restrict__ w2_ck, float* __restrict__ b2_ck,
                         float* __restrict__ work, int K) {
  __shared__ __align__(16) float stage[tttb::kStageFloats];
  __shared__ tttb::Vecs v;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int NG = (a.NC + K - 1) / K;
  float* w = work + (size_t)bh * TrainWork::kFloats;
  float* sW1 = w + TrainWork::kW1;
  float* sW2 = w + TrainWork::kW2;
  const tttb::StepTiles t{w + TrainWork::kXQ, w + TrainWork::kXK, w + TrainWork::kTG, w + TrainWork::kZ1,
                    w + TrainWork::kX2c, w + TrainWork::kG1, w + TrainWork::kX2b, w + TrainWork::kZ2,
                    w + TrainWork::kGZ2, w + TrainWork::kG2, w + TrainWork::kA1, w + TrainWork::kA2};

  for (int i = tid; i < tttb::kState; i += tttb::kThreads) {
    sW1[i] = W1[(size_t)h * tttb::kState + i];
    sW2[i] = W2[(size_t)h * tttb::kState + i];
  }
  v.b1[tid] = b1[(size_t)h * tttb::kF4 + tid];
  if (tid < tttb::kF) {
    v.b2[tid] = b2[(size_t)h * tttb::kF + tid];
    v.lnw[tid] = ln_w[(size_t)h * tttb::kF + tid];
    v.lnb[tid] = ln_b[(size_t)h * tttb::kF + tid];
  }
  __syncthreads();

  for (int n = 0; n < a.NC; ++n) {
    if (n % K == 0) {
      const size_t g = (size_t)bh * NG + n / K;
      for (int i = tid; i < tttb::kState; i += tttb::kThreads) {
        w1_ck[g * tttb::kState + i] = sW1[i];
        w2_ck[g * tttb::kState + i] = sW2[i];
      }
      b1_ck[g * tttb::kF4 + tid] = v.b1[tid];
      if (tid < tttb::kF) b2_ck[g * tttb::kF + tid] = v.b2[tid];
      __syncthreads();
    }
    tttb::forward_step(a, b, h, n, v, sW1, sW2, t, stage, out);
  }
}

}  // namespace

extern "C" long long ttt_mlp_forward_train_workspace_floats() { return TrainWork::kFloats; }

extern "C" int ttt_mlp_forward_train(const void* xq, const void* xk, const void* xv, const void* gate,
                                     const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                     const void* W1, const void* b1, const void* W2, const void* b2, void* out,
                                     void* w1_ck, void* b1_ck, void* w2_ck, void* b2_ck, void* work, int B, int NC,
                                     int H, int K, float eta_scale, void* stream) {
  const tttb::ScanArgs a{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                         static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                         static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), NC, H, eta_scale};
  ttt_mlp_fwd_train_kernel<<<B * H, tttb::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
      static_cast<const float*>(b1), static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(w1_ck), static_cast<float*>(b1_ck),
      static_cast<float*>(w2_ck), static_cast<float*>(b2_ck), static_cast<float*>(work), K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
