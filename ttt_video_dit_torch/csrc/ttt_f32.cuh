// The building blocks of the float32 TTT kernels (ttt_mlp_forward_f32.cu,
// ttt_mlp_backward_f32.cu, ttt_linear_forward_f32.cu,
// ttt_linear_backward_f32.cu): a block-wide float32 matrix product, the row
// passes of one mini-batch (a warp per token row, F = 64: two features a
// lane), the fused preprocessing, the state's moves, both variants' forward
// step and its workspace layout.
//
// At dt = float32 the JAX kernels' `.astype(dt)` casts are the identity, so
// these kernels round nothing to bf16 anywhere: every product is a float32
// FMA loop (one TF32 tensor-core pass keeps ~3 decimal digits, too few for
// the float32 references). Design, simple first: one block of 256 threads
// per (batch, head); the fast-weight state in shared memory; the per-step
// intermediates in a device-memory workspace the wrapper allocates (a block's:
// 21 KiB for K5 at CS 16 to 368 KiB for K1 at CS 64, in the L2 at the 3 s
// shapes; 1.28 MiB for K2 at CS 64, and the backwards' stash of K states
// beside it); every block-wide pass ends with
// __syncthreads, so the next pass reads what it wrote. Products stage
// 32-deep slices of both operands through shared memory (any strides: a
// transposed operand costs nothing extra) and give each thread a 4 x 4 tile
// of the output.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace tttf {

constexpr int kF = 64;         // head dim
constexpr int kH4 = 4 * kF;    // TTT-MLP hidden width
constexpr int kThreads = 256;  // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKc = 32;        // depth of a staged operand slice

// Floats of the staging tiles of the widest split (16 x 256 output tiles): As [kKc][16 + 4], Bs [kKc][256 + 4].
constexpr int kStageFloats = kKc * (16 + 4) + kKc * (256 + 4);

// The mini-batches the float32 kernels are launched for: ops/ttt_mlp_kernel.py and ops/ttt_linear_kernel.py name
// them KERNEL_MINI_BATCHES (a test holds these cases to the lists). The kernels loop over any CS; the wrappers and
// these entries keep to the list the bf16 kernels take.
inline bool takes_mini_batch(int cs) {
  switch (cs) {
    case 8: case 16: case 24: case 32: case 40: case 48: case 56: case 64: return true;
  }
  return false;
}

// A matrix operand: element (i, j) at p[i * rs + j * cs].
struct Mat {
  const float* p;
  int rs, cs;
};
__device__ __forceinline__ Mat rm(const float* p, int ld) { return Mat{p, ld, 1}; }  // row-major [.][ld]
__device__ __forceinline__ Mat tr(const float* p, int ld) { return Mat{p, 1, ld}; }  // the transpose of rm(p, ld)

// C[M][N] (row-major, ldc) = alpha * A B + beta * C over K, with a (TY x 4) x (256 / TY x 4) tile of the output
// at a time. With beta == 0 C is not read.
template <int TY>
__device__ void gemm_tiles(float* C, int ldc, int M, int N, int K, Mat A, Mat B, float alpha, float beta,
                           float* stage) {
  constexpr int TX = kThreads / TY, BM = 4 * TY, BN = 4 * TX, LA = BM + 4, LB = BN + 4;
  float* As = stage;             // As[k][m]
  float* Bs = stage + kKc * LA;  // Bs[k][n]
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += kKc) {
        for (int i = tid; i < BM * kKc; i += kThreads) {
          int m, k;
          if (A.cs == 1) {
            k = i % kKc, m = i / kKc;
          } else {
            m = i % BM, k = i / BM;
          }
          const int gm = m0 + m, gk = k0 + k;
          As[k * LA + m] = (gm < M && gk < K) ? A.p[(size_t)gm * A.rs + (size_t)gk * A.cs] : 0.f;
        }
        for (int i = tid; i < BN * kKc; i += kThreads) {
          int n, k;
          if (B.rs == 1) {
            k = i % kKc, n = i / kKc;
          } else {
            n = i % BN, k = i / BN;
          }
          const int gn = n0 + n, gk = k0 + k;
          Bs[k * LB + n] = (gn < N && gk < K) ? B.p[(size_t)gk * B.rs + (size_t)gn * B.cs] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kKc; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(As + k * LA + 4 * ty);
          const float4 b = *reinterpret_cast<const float4*>(Bs + k * LB + 4 * tx);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + 4 * ty + i;
        if (m >= M) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 4 * tx + j;
          if (n < N) {
            float* c = C + (size_t)m * ldc + n;
            *c = beta == 0.f ? alpha * acc[i][j] : fmaf(beta, *c, alpha * acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
}

// The block-wide product C = alpha * A B + beta * C, A [M][K], B [K][N]; the output tiles' shape follows M (a
// mini-batch of 8 or 16 rows takes 16 x 256 tiles, a [4F][F] update 64 x 64). Ends with __syncthreads.
__device__ __forceinline__ void gemm(float* C, int ldc, int M, int N, int K, Mat A, Mat B, float alpha, float beta,
                                     float* stage) {
  if (M <= 16) {
    gemm_tiles<4>(C, ldc, M, N, K, A, B, alpha, beta, stage);
  } else if (M <= 32) {
    gemm_tiles<8>(C, ldc, M, N, K, A, B, alpha, beta, stage);
  } else {
    gemm_tiles<16>(C, ldc, M, N, K, A, B, alpha, beta, stage);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tanh GELU and its first two derivatives (ops/ln.py: gelu_tanh, gelu_bwd, gelu_bwd2).
__device__ __forceinline__ float gelu(float x) {
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

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ float2 f2(float x, float y) { return make_float2(x, y); }

// Row r of a [CS][cols] buffer, features 2 lane, 2 lane + 1 (cols = F).
__device__ __forceinline__ float2 row2(const float* buf, int r, int lane) { return ld2(buf + r * kF + 2 * lane); }

// The per-step inputs of one scan, and its (batch, head).
struct Scan {
  const float *xq, *xk, *xv;  // [B, NC, CS, H*F] raw projections
  const float* gate;          // [B, H, NC, CS] pre-sigmoid logits
  const float *cos, *sin;     // [NC, CS, F]
  const float *ln_w, *ln_b;   // [H, F]
  int NC, H, CS;
  float eta_scale;
  int b, h;
  // Offset of token r of mini-batch n in a [B, NC, CS, H*F] tensor, at feature 0 of this head.
  __device__ size_t tok(int n, int r) const { return (((size_t)b * NC + n) * CS + r) * ((size_t)H * kF) + (size_t)h * kF; }
  __device__ size_t tab(int n, int r) const { return ((size_t)n * CS + r) * kF; }
  __device__ size_t gate_at(int n) const { return (((size_t)b * H + h) * NC + n) * CS; }
};

// The fused preprocessing of mini-batch n (ops/ttt_mlp_kernel.py:_preproc): XQ, XK = rope(L2-norm(q, k)); the
// LN-reconstruction target of v - XK (unbiased std, 1e-8 on the std) with its t_hat and std (t_hat and s may be
// null); eta = sigmoid(gate) * eta_scale and sigmoid(gate) (sig may be null). Ends with __syncthreads.
__device__ void prep(const Scan& S, int n, float* xq, float* xk, float* tgt, float* t_hat, float* s_t, float* eta,
                     float* sig) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = 2 * lane;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);
  for (int r = warp; r < S.CS; r += kWarps) {
    const size_t o = S.tok(n, r) + f, t = S.tab(n, r) + f;
    const float2 c = ld2(S.cos + t), s = ld2(S.sin + t);
    float2 q = ld2(S.xq + o), k = ld2(S.xk + o);
    const float2 v = ld2(S.xv + o);
    const float mq = fmaxf(sqrtf(warp_sum(q.x * q.x + q.y * q.y)), 1e-12f);
    const float mk = fmaxf(sqrtf(warp_sum(k.x * k.x + k.y * k.y)), 1e-12f);
    q = f2(q.x / mq, q.y / mq);
    k = f2(k.x / mk, k.y / mk);
    // x * cos + pair_swap(x) * sin, pair_swap(x)[2i] = -x[2i+1], [2i+1] = x[2i]
    q = f2(q.x * c.x - q.y * s.x, q.y * c.y + q.x * s.y);
    k = f2(k.x * c.x - k.y * s.x, k.y * c.y + k.x * s.y);
    st2(xq + r * kF + f, q);
    st2(xk + r * kF + f, k);
    const float2 d0 = f2(v.x - k.x, v.y - k.y);
    const float mu = warp_sum(d0.x + d0.y) / kF;
    const float2 d = f2(d0.x - mu, d0.y - mu);
    const float var = warp_sum(d.x * d.x + d.y * d.y) / kF * ((float)kF / (kF - 1));
    const float sd = sqrtf(var) + 1e-8f;
    const float2 th = f2(d.x / sd, d.y / sd);
    st2(tgt + r * kF + f, f2(lw.x * th.x + lb.x, lw.y * th.y + lb.y));
    if (t_hat != nullptr) {
      st2(t_hat + r * kF + f, th);
      if (lane == 0) s_t[r] = sd;
    }
  }
  for (int r = threadIdx.x; r < S.CS; r += kThreads) {
    const float sg = 1.f / (1.f + expf(-S.gate[S.gate_at(n) + r]));
    eta[r] = sg * S.eta_scale;
    if (sig != nullptr) sig[r] = sg;
  }
  __syncthreads();
}

// Row statistics of the inner LayerNorm (ops/ln.py:ln_stats, eps 1e-8 on the biased variance) of x: (x_hat, std).
__device__ __forceinline__ float2 ln_hat(float2 x, float& sd) {
  const float mu = warp_sum(x.x + x.y) / kF;
  const float2 d = f2(x.x - mu, x.y - mu);
  sd = sqrtf(warp_sum(d.x * d.x + d.y * d.y) / kF + 1e-8f);
  return f2(d.x / sd, d.y / sd);
}

// ops/ln.py:ln_fused_l2_bwd of one row: d/dx 0.5 || LN(x) - target ||^2.
__device__ __forceinline__ float2 ln_fused_l2_bwd(float2 x, float2 tg, float2 lw, float2 lb) {
  float sd;
  const float2 xh = ln_hat(x, sd);
  const float2 gxh = f2((lw.x * xh.x + lb.x - tg.x) * lw.x, (lw.y * xh.y + lb.y - tg.y) * lw.y);
  const float s1 = warp_sum(gxh.x + gxh.y), s2 = warp_sum(gxh.x * xh.x + gxh.y * xh.y);
  return f2((1.f / kF) * (kF * gxh.x - s1 - xh.x * s2) / sd, (1.f / kF) * (kF * gxh.y - s1 - xh.y * s2) / sd);
}

// ops/ln.py:ln_fused_l2 of one row from its statistics (the backward's form).
__device__ __forceinline__ float2 ln_fused_l2(float2 xh, float sd, float2 tg, float2 lw, float2 lb) {
  const float2 gx = f2(lw.x * (lw.x * xh.x + lb.x - tg.x), lw.y * (lw.y * xh.y + lb.y - tg.y));
  const float m1 = warp_sum(gx.x + gx.y) / kF, m2 = warp_sum(gx.x * xh.x + gx.y * xh.y) / kF;
  return f2((gx.x - m1 - xh.x * m2) / sd, (gx.y - m1 - xh.y * m2) / sd);
}

// out row r of mini-batch n = XQ + ln_fwd(z) (eps 1e-8 on the biased variance), to the token-major output.
__device__ __forceinline__ void write_out(float* out, const Scan& S, int n, int r, int lane, float2 xq, float2 z) {
  const int f = 2 * lane;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);
  float sd;
  const float2 zh = ln_hat(z, sd);
  st2(out + S.tok(n, r) + f, f2(xq.x + lw.x * zh.x + lb.x, xq.y + lw.y * zh.y + lb.y));
}

// dst[j] += sign * sum_r src[r][j] over rows < rows, j < cols (ld = cols). Ends with __syncthreads.
__device__ void colsum(float* dst, const float* src, int rows, int cols, float sign) {
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += src[(size_t)r * cols + j];
    dst[j] += sign * s;
  }
  __syncthreads();
}

// dst[i] = src[i] over n floats (n a multiple of 4, both 16-byte aligned). Ends with __syncthreads.
__device__ void copy(float* dst, const float* src, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
  __syncthreads();
}

// A bump allocator of float offsets, each rounded up to 4 floats (16 bytes): the same layout on the host (the
// workspace's size) and on the device.
struct Bump {
  size_t off = 0;
  __host__ __device__ size_t take(size_t n) {
    const size_t o = off;
    off += (n + 3) & ~(size_t)3;
    return o;
  }
};

// ------------------------------------------------------------ the forward steps

// The fast-weight state of one scan, in shared memory: TTT-MLP W1 [F][4F], b1 [4F], W2 [4F][F], b2 [F];
// TTT-linear W1 [F][F], b1 [F] (W2 and b2 null).
struct State {
  float *W1, *b1, *W2, *b2;
};

// The floats of one head's state, and the state's place in shared memory before the staging tiles.
__host__ __device__ constexpr int state_floats(bool mlp) { return mlp ? 2 * kF * kH4 + kH4 + kF : kF * kF + kF; }
__device__ __forceinline__ State state_at(float* smem, bool mlp) {
  if (!mlp) return State{smem, smem + kF * kF, nullptr, nullptr};
  return State{smem, smem + 2 * kF * kH4, smem + kF * kH4, smem + 2 * kF * kH4 + kH4};
}

// Copy a state between shared memory and a compact [W1, b1, W2, b2] record (the checkpoints' order, one head's:
// ck_W1 = base, ck_b1 ... at the offsets the wrapper's tensors give). Ends with __syncthreads.
__device__ void load_state(const State& st, const float* W1, const float* b1, const float* W2, const float* b2,
                           bool mlp) {
  const int w = mlp ? kF * kH4 : kF * kF, b = mlp ? kH4 : kF;
  for (int i = threadIdx.x; i < w; i += kThreads) st.W1[i] = W1[i];
  for (int i = threadIdx.x; i < b; i += kThreads) st.b1[i] = b1[i];
  if (mlp) {
    for (int i = threadIdx.x; i < w; i += kThreads) st.W2[i] = W2[i];
    for (int i = threadIdx.x; i < kF; i += kThreads) st.b2[i] = b2[i];
  }
  __syncthreads();
}
__device__ void save_state(const State& st, float* W1, float* b1, float* W2, float* b2, bool mlp) {
  const int w = mlp ? kF * kH4 : kF * kF, b = mlp ? kH4 : kF;
  for (int i = threadIdx.x; i < w; i += kThreads) W1[i] = st.W1[i];
  for (int i = threadIdx.x; i < b; i += kThreads) b1[i] = st.b1[i];
  if (mlp) {
    for (int i = threadIdx.x; i < w; i += kThreads) W2[i] = st.W2[i];
    for (int i = threadIdx.x; i < kF; i += kThreads) b2[i] = st.b2[i];
  }
  __syncthreads();
}

// The forward step's workspace (floats from one block's base): the prepared XQ, XK, target and eta, and
// TTT-MLP's Z1, X2 = gelu(Z1), G1, Z1_bar, G2, Z2_bar, attn1, attn2 (TTT-linear: G in g2, Z1_bar in zb2, attn in
// a1).
struct FwdWork {
  size_t xq, xk, tgt, eta, z1, x2, g1, zb1, g2, zb2, a1, a2, floats;
  __host__ __device__ FwdWork(int cs, bool mlp) {
    Bump m;
    const size_t cf = (size_t)cs * kF, ch = mlp ? (size_t)cs * kH4 : 0;
    xq = m.take(cf), xk = m.take(cf), tgt = m.take(cf), eta = m.take(cs);
    z1 = m.take(ch), x2 = m.take(ch), g1 = m.take(ch), zb1 = m.take(ch);
    g2 = m.take(cf), zb2 = m.take(cf), a1 = m.take((size_t)cs * cs), a2 = m.take(mlp ? (size_t)cs * cs : 0);
    floats = m.off;
  }
};

// One dual-form TTT-MLP step of mini-batch n (ops/ttt_scan.py:ttt_mlp_step, all in float32): the state in `st`
// moves to the next step's; with `out`, the output row XQ + LN(Z2_bar) goes to the token-major output.
__device__ void mlp_step(const Scan& S, int n, const State& st, float* w, const FwdWork& L, float* stage,
                         float* out) {
  const int CS = S.CS, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = 2 * lane;
  float *xq = w + L.xq, *xk = w + L.xk, *tgt = w + L.tgt, *eta = w + L.eta, *z1 = w + L.z1, *x2 = w + L.x2;
  float *g1 = w + L.g1, *zb1 = w + L.zb1, *g2 = w + L.g2, *zb2 = w + L.zb2, *a1 = w + L.a1, *a2 = w + L.a2;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);
  prep(S, n, xq, xk, tgt, nullptr, nullptr, eta, nullptr);
  gemm(z1, kH4, CS, kH4, kF, rm(xk, kF), rm(st.W1, kH4), 1.f, 0.f, stage);  // Z1 = XK W1 (+ b1 below)
  for (int i = threadIdx.x; i < CS * kH4; i += kThreads) {
    const float z = z1[i] + st.b1[i % kH4];
    z1[i] = z;
    x2[i] = gelu(z);
  }
  __syncthreads();
  gemm(g2, kF, CS, kF, kH4, rm(x2, kH4), rm(st.W2, kF), 1.f, 0.f, stage);  // Z2 = X2 W2 (+ b2 below)
  const float2 b2 = ld2(st.b2 + f);
  for (int r = warp; r < CS; r += kWarps) {  // G2 = eta * grad_z2
    const float2 z = row2(g2, r, lane);
    const float2 g = ln_fused_l2_bwd(f2(z.x + b2.x, z.y + b2.y), row2(tgt, r, lane), lw, lb);
    st2(g2 + r * kF + f, f2(eta[r] * g.x, eta[r] * g.y));
  }
  __syncthreads();
  gemm(g1, kH4, CS, kH4, kF, rm(g2, kF), tr(st.W2, kF), 1.f, 0.f, stage);  // G1 = (G2 W2^T) * gelu'(Z1)
  for (int i = threadIdx.x; i < CS * kH4; i += kThreads) g1[i] *= gelu_bwd(z1[i]);
  __syncthreads();
  colsum(st.b1, g1, CS, kH4, -1.f);  // b1' = b1 - colsum(G1)
  colsum(st.b2, g2, CS, kF, -1.f);   // b2' = b2 - colsum(G2)
  if (out != nullptr) {
    gemm(a1, CS, CS, CS, kF, rm(xq, kF), tr(xk, kF), 1.f, 0.f, stage);         // attn1 = XQ XK^T
    gemm(zb1, kH4, CS, kH4, kF, rm(xq, kF), rm(st.W1, kH4), 1.f, 0.f, stage);  // Z1_bar = XQ W1 - attn1 G1 + b1'
    gemm(zb1, kH4, CS, kH4, CS, rm(a1, CS), rm(g1, kH4), -1.f, 1.f, stage);
    for (int i = threadIdx.x; i < CS * kH4; i += kThreads) zb1[i] = gelu(zb1[i] + st.b1[i % kH4]);  // X2_bar
    __syncthreads();
    gemm(a2, CS, CS, CS, kH4, rm(zb1, kH4), tr(x2, kH4), 1.f, 0.f, stage);   // attn2 = X2_bar X2^T
    gemm(zb2, kF, CS, kF, kH4, rm(zb1, kH4), rm(st.W2, kF), 1.f, 0.f, stage);  // Z2_bar = X2_bar W2 - attn2 G2 + b2'
    gemm(zb2, kF, CS, kF, CS, rm(a2, CS), rm(g2, kF), -1.f, 1.f, stage);
    const float2 b2n = ld2(st.b2 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(zb2, r, lane);
      write_out(out, S, n, r, lane, row2(xq, r, lane), f2(z.x + b2n.x, z.y + b2n.y));
    }
    __syncthreads();
  }
  gemm(st.W1, kH4, kF, kH4, CS, tr(xk, kF), rm(g1, kH4), -1.f, 1.f, stage);  // W1' = W1 - XK^T G1
  gemm(st.W2, kF, kH4, kF, CS, tr(x2, kH4), rm(g2, kF), -1.f, 1.f, stage);   // W2' = W2 - X2^T G2
}

// One dual-form TTT-linear step of mini-batch n (ops/ttt_scan.py:ttt_linear_step, all in float32).
__device__ void linear_step(const Scan& S, int n, const State& st, float* w, const FwdWork& L, float* stage,
                            float* out) {
  const int CS = S.CS, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, f = 2 * lane;
  float *xq = w + L.xq, *xk = w + L.xk, *tgt = w + L.tgt, *eta = w + L.eta, *g = w + L.g2, *zb = w + L.zb2;
  float* a1 = w + L.a1;
  const float2 lw = ld2(S.ln_w + (size_t)S.h * kF + f), lb = ld2(S.ln_b + (size_t)S.h * kF + f);
  prep(S, n, xq, xk, tgt, nullptr, nullptr, eta, nullptr);
  gemm(g, kF, CS, kF, kF, rm(xk, kF), rm(st.W1, kF), 1.f, 0.f, stage);  // Z1 = XK W (+ b below)
  const float2 b = ld2(st.b1 + f);
  for (int r = warp; r < CS; r += kWarps) {  // G = eta * grad
    const float2 z = row2(g, r, lane);
    const float2 gr = ln_fused_l2_bwd(f2(z.x + b.x, z.y + b.y), row2(tgt, r, lane), lw, lb);
    st2(g + r * kF + f, f2(eta[r] * gr.x, eta[r] * gr.y));
  }
  __syncthreads();
  colsum(st.b1, g, CS, kF, -1.f);  // b' = b - colsum(G)
  if (out != nullptr) {
    gemm(a1, CS, CS, CS, kF, rm(xq, kF), tr(xk, kF), 1.f, 0.f, stage);    // attn = XQ XK^T
    gemm(zb, kF, CS, kF, kF, rm(xq, kF), rm(st.W1, kF), 1.f, 0.f, stage);  // Z1_bar = XQ W - attn G + b'
    gemm(zb, kF, CS, kF, CS, rm(a1, CS), rm(g, kF), -1.f, 1.f, stage);
    const float2 bn = ld2(st.b1 + f);
    for (int r = warp; r < CS; r += kWarps) {
      const float2 z = row2(zb, r, lane);
      write_out(out, S, n, r, lane, row2(xq, r, lane), f2(z.x + bn.x, z.y + bn.y));
    }
    __syncthreads();
  }
  gemm(st.W1, kF, kF, kF, CS, tr(xk, kF), rm(g, kF), -1.f, 1.f, stage);  // W' = W - XK^T G
}

// The launch, in one place: B * H blocks of kThreads threads with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename Args>
inline int launch(Kernel kernel, int blocks, int smem, void* stream, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tttf
