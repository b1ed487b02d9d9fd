// Block-level building blocks of the TTT-MLP training kernels (K1-train in
// ttt_mlp_forward.cu, K2 in ttt_mlp_backward.cu), head_dim F = 64 and
// mini-batch CS = 64, for Hopper (sm_90a).
//
// One block of 256 threads owns one (batch, head) scan. At CS = 64 a step's
// fp32 tiles (~0.5 MiB) do not fit one SM's 227 KB of shared memory next to
// the 128 KiB fp32 state, so the state and every per-step tile live in a
// per-block fp32 workspace in device memory (0.5 MiB for K1-train, ~2.5 MiB
// for K2; at 48 heads the forward's stays in the 50 MB L2). Shared memory
// holds only the staging tiles of the matrix products and the per-row and
// per-column vectors. Every product goes through mm(): 64x64 output tiles,
// 32-deep K chunks staged in shared memory, a 4x4 micro-tile of fp32 FMAs
// per thread. Operands are rounded to bf16 at load exactly where the JAX
// kernels call .astype(dt), so each product is exact and only the fp32
// summation order differs from the plain versions. Every helper is called by
// all 256 threads and ends with __syncthreads().
// Not yet done (later work): tensor cores (mma.sync/wgmma on the bf16
// operands), keeping the tiles on chip, more than one scan per SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace tttb {

constexpr int kF = 64;         // head dim
constexpr int kF4 = 4 * kF;    // hidden width of the fast-weight MLP
constexpr int kCS = 64;        // mini-batch
constexpr int kThreads = 256;  // 8 warps
constexpr int kKc = 32;        // K chunk of mm()
constexpr int kLdS = 68;       // row stride of the mm() staging tiles, in floats
constexpr int kStageFloats = 2 * kKc * kLdS;
constexpr int kTile = kCS * kF;    // floats in a [CS][F] (or [CS][CS]) tile
constexpr int kWide = kCS * kF4;   // floats in a [CS][4F] tile
constexpr int kState = kF * kF4;   // floats in W1 (or W2)

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.79788456f * x * (1.f + 0.044715f * x * x)));
}

__device__ __forceinline__ float gelu_bwd(float x) {
  const float t = tanhf(0.79788456f * x * (1.f + 0.044715f * x * x));
  return 0.5f * x * ((1.f - t * t) * (0.79788456f + 0.1070322243f * x * x)) + 0.5f * (1.f + t);
}

__device__ __forceinline__ float gelu_bwd2(float x) {
  const float a = 0.79788456f, c3 = 0.1070322243f;
  const float T = tanhf(a * x + (c3 / 3.f) * x * x * x);
  const float up = a + c3 * x * x, upp = 2.f * c3 * x;
  return (1.f - T * T) * (up + 0.5f * x * (upp - 2.f * T * up * up));
}

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// C(m, n) = alpha * sum_k A(m, k) B(k, n) [+ C(m, n) if accumulate], with
// A(m, k) = A[m * sam + k * sak] and B(k, n) = B[k * sbk + n * sbn] (so a
// transpose is a swap of strides), each operand optionally rounded to bf16
// at load (ra, rb). M and N are multiples of 64, K of 32. C must not alias
// A or B. ``stage`` is kStageFloats of shared memory.
template <typename TA, typename TB>
__device__ void mm(int M, int N, int K, const TA* A, int sam, int sak, bool ra, const TB* B, int sbk, int sbn,
                   bool rb, float* C, int ldc, float alpha, bool accumulate, float* stage) {
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  float* As = stage;               // [kKc][kLdS]: As[k][m]
  float* Bs = stage + kKc * kLdS;  // [kKc][kLdS]: Bs[k][n]
  for (int m0 = 0; m0 < M; m0 += 64) {
    for (int n0 = 0; n0 < N; n0 += 64) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kKc) {
        for (int i = tid; i < kKc * 64; i += kThreads) {
          // Walk the operand's contiguous index fastest across threads.
          const int mm_ = sam == 1 ? (i & 63) : (i >> 5), ka = sam == 1 ? (i >> 6) : (i & 31);
          float a = ldf(A + (size_t)(m0 + mm_) * sam + (size_t)(k0 + ka) * sak);
          As[ka * kLdS + mm_] = ra ? bf16r(a) : a;
          const int nn = sbn == 1 ? (i & 63) : (i >> 5), kb = sbn == 1 ? (i >> 6) : (i & 31);
          float b = ldf(B + (size_t)(k0 + kb) * sbk + (size_t)(n0 + nn) * sbn);
          Bs[kb * kLdS + nn] = rb ? bf16r(b) : b;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kKc; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(As + kk * kLdS + ty * 4);
          const float4 b = *reinterpret_cast<const float4*>(Bs + kk * kLdS + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* c = C + (size_t)(m0 + ty * 4 + i) * ldc + n0 + tx * 4 + j;
          *c = accumulate ? *c + alpha * acc[i][j] : alpha * acc[i][j];
        }
    }
  }
  __syncthreads();
}

// out[c] = sum_r X[r][c] over the CS rows of a [CS][N] tile (N <= 256).
__device__ __forceinline__ void colsum(const float* X, int N, float* out) {
  const int c = threadIdx.x;
  if (c < N) {
    float s = 0.f;
    for (int r = 0; r < kCS; ++r) s += X[r * N + c];
    out[c] = s;
  }
  __syncthreads();
}

// The per-step inputs and parameters of one (batch, head) scan.
struct ScanArgs {
  const __nv_bfloat16 *xq, *xk, *xv;  // [B, NC, CS, H*F]
  const float* gate;                  // [B, H, NC, CS] pre-sigmoid logits
  const float *cos, *sin;             // [NC, CS, F]
  int NC, H;
  float eta_scale;
};

// Shared-memory vectors of one scan.
struct Vecs {
  float b1[kF4], b2[kF];    // fp32 biases of the fast-weight state
  float lnw[kF], lnb[kF];   // ttt_norm affine
  float eta[kCS], sig[kCS]; // sigmoid(gate) * eta_scale, sigmoid(gate)
  float cs[kF4];            // column sums
};

// Per-step tiles that the forward step writes (pointers into the workspace).
struct StepTiles {
  float *XQ, *XK, *TG;       // [CS][F]: bf16-rounded XQ, XK after preprocessing; LN target
  float *Z1, *X2c, *G1;      // [CS][4F]
  float *X2b;                // [CS][4F]  (forward only)
  float *Z2, *GZ2, *G2;      // [CS][F]
  float *A1, *A2;            // [CS][CS]  (forward only)
};

// Preprocessing of mini-batch n (ttt_forward.py:_fused_preproc and
// _eta_from_gate): XQ/XK = bf16(rope(l2norm(raw))), TG = LN-reconstruction
// target of XV - XK (unbiased std, eps on the std), eta and sigmoid(gate).
// With t_hat/s_t, also keeps the target's normalized rows and stds.
__device__ void preprocess(const ScanArgs& a, int b, int h, int n, Vecs& v, float* XQ, float* XK, float* TG,
                           float* t_hat, float* s_t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = 2 * lane;
  const size_t HF = (size_t)a.H * kF;
  for (int r = warp; r < kCS; r += 8) {
    const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xq + xo));
    const float2 k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xk + xo));
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xv + xo));
    const size_t to = ((size_t)n * kCS + r) * kF + f0;
    const float2 c = *reinterpret_cast<const float2*>(a.cos + to);
    const float2 s = *reinterpret_cast<const float2*>(a.sin + to);
    const float dq = fmaxf(sqrtf(warp_sum(q.x * q.x + q.y * q.y)), 1e-12f);
    const float dk = fmaxf(sqrtf(warp_sum(k.x * k.x + k.y * k.y)), 1e-12f);
    const float qn0 = q.x / dq, qn1 = q.y / dq, kn0 = k.x / dk, kn1 = k.y / dk;
    const float XQ0 = qn0 * c.x + (-qn1) * s.x, XQ1 = qn1 * c.y + qn0 * s.y;
    const float XK0 = kn0 * c.x + (-kn1) * s.x, XK1 = kn1 * c.y + kn0 * s.y;
    const float t0 = x.x - XK0, t1 = x.y - XK1;
    const float mu = warp_sum(t0 + t1) * (1.f / kF);
    const float d0 = t0 - mu, d1 = t1 - mu;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) * ((float)kF / (kF - 1));
    const float sd = sqrtf(var) + 1e-8f;
    const float th0 = d0 / sd, th1 = d1 / sd;
    TG[r * kF + f0] = v.lnw[f0] * th0 + v.lnb[f0];
    TG[r * kF + f0 + 1] = v.lnw[f0 + 1] * th1 + v.lnb[f0 + 1];
    XQ[r * kF + f0] = bf16r(XQ0);
    XQ[r * kF + f0 + 1] = bf16r(XQ1);
    XK[r * kF + f0] = bf16r(XK0);
    XK[r * kF + f0 + 1] = bf16r(XK1);
    if (t_hat != nullptr) {
      t_hat[r * kF + f0] = th0;
      t_hat[r * kF + f0 + 1] = th1;
      if (lane == 0) s_t[r] = sd;
    }
    if (lane == 0) {
      const float sg = 1.f / (1.f + expf(-a.gate[(((size_t)b * a.H + h) * a.NC + n) * kCS + r]));
      v.sig[r] = sg;
      v.eta[r] = sg * a.eta_scale;
    }
  }
  __syncthreads();
}

// One dual-form step of the fast-weight MLP on the fp32 state W1/W2 (device
// memory) and v.b1/v.b2 (shared), rounding where _mlp_kernel rounds
// (ttt_forward.py:298-322). With ``out`` it also writes XQ + LN(Z2_bar) for
// mini-batch n; without, it only advances the state (the backward's pass A).
__device__ void forward_step(const ScanArgs& a, int b, int h, int n, Vecs& v, float* W1, float* W2,
                             const StepTiles& t, float* stage, __nv_bfloat16* out) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int f0 = 2 * lane;
  preprocess(a, b, h, n, v, t.XQ, t.XK, t.TG, nullptr, nullptr);

  // Z1 = XK @ bf16(W1) + b1; X2c = bf16(gelu(Z1)).
  mm(kCS, kF4, kF, t.XK, kF, 1, false, W1, kF4, 1, true, t.Z1, kF4, 1.f, false, stage);
  for (int i = tid; i < kWide; i += kThreads) {
    const float z = t.Z1[i] + v.b1[i & (kF4 - 1)];
    t.Z1[i] = z;
    t.X2c[i] = bf16r(gelu_tanh(z));
  }
  __syncthreads();

  // Z2 = X2c @ bf16(W2) + b2; grad_z2 = ln_fused_l2_bwd(Z2, target) (eps 1e-8 on the biased var).
  mm(kCS, kF, kF4, t.X2c, kF4, 1, false, W2, kF, 1, true, t.Z2, kF, 1.f, false, stage);
  for (int r = warp; r < kCS; r += 8) {
    const float lw0 = v.lnw[f0], lw1 = v.lnw[f0 + 1], lb0 = v.lnb[f0], lb1 = v.lnb[f0 + 1];
    const float x0 = t.Z2[r * kF + f0] + v.b2[f0], x1 = t.Z2[r * kF + f0 + 1] + v.b2[f0 + 1];
    const float mu = warp_sum(x0 + x1) * (1.f / kF);
    const float d0 = x0 - mu, d1 = x1 - mu;
    const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
    const float xh0 = d0 / sd, xh1 = d1 / sd;
    const float gx0 = (lw0 * xh0 + lb0 - t.TG[r * kF + f0]) * lw0;
    const float gx1 = (lw1 * xh1 + lb1 - t.TG[r * kF + f0 + 1]) * lw1;
    const float s1 = warp_sum(gx0 + gx1), s2 = warp_sum(gx0 * xh0 + gx1 * xh1);
    const float g0 = (1.f / kF) * (kF * gx0 - s1 - xh0 * s2) / sd;
    const float g1 = (1.f / kF) * (kF * gx1 - s1 - xh1 * s2) / sd;
    const float eta = v.eta[r];
    t.GZ2[r * kF + f0] = bf16r(g0);
    t.GZ2[r * kF + f0 + 1] = bf16r(g1);
    t.G2[r * kF + f0] = bf16r(eta * g0);
    t.G2[r * kF + f0 + 1] = bf16r(eta * g1);
  }
  __syncthreads();

  // G1 = bf16(eta * ((bf16(grad_z2) @ bf16(W2)^T) * gelu'(Z1))).
  mm(kCS, kF4, kF, t.GZ2, kF, 1, false, W2, 1, kF, true, t.G1, kF4, 1.f, false, stage);
  for (int i = tid; i < kWide; i += kThreads) t.G1[i] = bf16r(v.eta[i / kF4] * (t.G1[i] * gelu_bwd(t.Z1[i])));
  __syncthreads();

  if (out != nullptr) {  // attn1 = bf16(XQ @ XK^T)
    mm(kCS, kCS, kF, t.XQ, kF, 1, false, t.XK, 1, kF, false, t.A1, kCS, 1.f, false, stage);
    for (int i = tid; i < kTile; i += kThreads) t.A1[i] = bf16r(t.A1[i]);
    __syncthreads();
  }
  colsum(t.G1, kF4, v.cs);
  v.b1[tid] -= v.cs[tid];  // b1' = b1 - colsum(G1)
  __syncthreads();

  if (out != nullptr) {  // Z1_bar = XQ @ bf16(W1) - attn1 @ G1 + b1'; X2_barc = bf16(gelu(Z1_bar)).
    mm(kCS, kF4, kF, t.XQ, kF, 1, false, W1, kF4, 1, true, t.Z1, kF4, 1.f, false, stage);
    mm(kCS, kF4, kCS, t.A1, kCS, 1, false, t.G1, kF4, 1, false, t.Z1, kF4, -1.f, true, stage);
    for (int i = tid; i < kWide; i += kThreads) t.X2b[i] = bf16r(gelu_tanh(t.Z1[i] + v.b1[i & (kF4 - 1)]));
    __syncthreads();
  }
  // W1 -= XK^T @ G1.
  mm(kF, kF4, kCS, t.XK, 1, kF, false, t.G1, kF4, 1, false, W1, kF4, -1.f, true, stage);

  if (out != nullptr) {  // attn2 = bf16(X2_barc @ X2c^T)
    mm(kCS, kCS, kF4, t.X2b, kF4, 1, false, t.X2c, 1, kF4, false, t.A2, kCS, 1.f, false, stage);
    for (int i = tid; i < kTile; i += kThreads) t.A2[i] = bf16r(t.A2[i]);
    __syncthreads();
  }
  colsum(t.G2, kF, v.cs);
  if (tid < kF) v.b2[tid] -= v.cs[tid];  // b2' = b2 - colsum(G2)
  __syncthreads();

  if (out != nullptr) {  // Z2_bar = X2_barc @ bf16(W2) - attn2 @ G2 + b2'; out = XQ + LN(Z2_bar).
    mm(kCS, kF, kF4, t.X2b, kF4, 1, false, W2, kF, 1, true, t.Z2, kF, 1.f, false, stage);
    mm(kCS, kF, kCS, t.A2, kCS, 1, false, t.G2, kF, 1, false, t.Z2, kF, -1.f, true, stage);
    const size_t HF = (size_t)a.H * kF;
    for (int r = warp; r < kCS; r += 8) {
      const float x0 = t.Z2[r * kF + f0] + v.b2[f0], x1 = t.Z2[r * kF + f0 + 1] + v.b2[f0 + 1];
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float o0 = t.XQ[r * kF + f0] + (v.lnw[f0] * (d0 / sd) + v.lnb[f0]);
      const float o1 = t.XQ[r * kF + f0 + 1] + (v.lnw[f0 + 1] * (d1 / sd) + v.lnb[f0 + 1]);
      const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
      *reinterpret_cast<__nv_bfloat162*>(out + xo) = __floats2bfloat162_rn(o0, o1);
    }
    __syncthreads();
  }
  // W2 -= X2c^T @ G2.
  mm(kF4, kF, kCS, t.X2c, 1, kF4, false, t.G2, kF, 1, false, W2, kF, -1.f, true, stage);
}

}  // namespace tttb
