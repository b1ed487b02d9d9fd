// Row-wise building blocks of the TTT-linear kernels (K5 in
// ttt_linear_forward.cu, K6 in ttt_linear_backward.cu), head_dim F = 64 and
// mini-batch CS = 16, for Hopper (sm_90a).
//
// One block of 256 threads (8 warps) owns one (batch, head) scan. In the
// row-wise phases warp w owns rows 2w and 2w + 1 of the [CS][F] step tiles
// and lane l owns features 2l and 2l + 1, so a row's reductions are warp
// shuffles and a lane keeps its rows' per-element values (target, LN
// statistics, raw projections) in registers from one phase to the next.
// The formulas are the plain versions' (ops/ttt_linear_kernel.py, ops/ln.py)
// term by term.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "ttt_mlp_block.cuh"

namespace tttl {

constexpr int kF = 64;
constexpr int kCS = 16;
constexpr int kThreads = 256;
constexpr int kLdX = kF + 4;  // row stride of the [CS][F] tiles (16-byte aligned rows)

using tttb::bf16r;
using tttb::ScanArgs;
using tttb::warp_sum;

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// One lane's share of one row of mini-batch n after the fused preprocessing.
struct Row {
  float2 q, k;    // raw projections (for the L2-norm VJP)
  float2 c, s;    // rope tables
  float2 XQ, XK;  // L2-normed and rotated, float32 (the kernels round them to bf16 as operands)
  float2 tgt;     // LN-reconstruction target
  float2 that;    // its normalised input (t - mu) / sd
  float sd;       // sqrt(unbiased var) + 1e-8
  float eta, sig; // sigmoid(gate) * eta_scale, sigmoid(gate)
};

// L2-norm + rope of the raw q/k projections, the LN-reconstruction target
// from v - XK (unbiased std, eps added to the std) and the gate, for row r
// of mini-batch n, features f0 and f0 + 1.
__device__ __forceinline__ Row preproc(const ScanArgs& a, int b, int h, int n, int r, int f0, float2 lw, float2 lb) {
  Row p;
  const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * ((size_t)a.H * kF) + (size_t)h * kF + f0;
  p.q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xq + xo));
  p.k = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xk + xo));
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.xv + xo));
  const size_t to = ((size_t)n * kCS + r) * kF + f0;
  p.c = *reinterpret_cast<const float2*>(a.cos + to);
  p.s = *reinterpret_cast<const float2*>(a.sin + to);

  // L2-norm: x / max(||x||, 1e-12); rope: x*cos + (x@R)*sin, (x@R) = (-x1, x0).
  const float dq = fmaxf(sqrtf(warp_sum(p.q.x * p.q.x + p.q.y * p.q.y)), 1e-12f);
  const float dk = fmaxf(sqrtf(warp_sum(p.k.x * p.k.x + p.k.y * p.k.y)), 1e-12f);
  const float qn0 = p.q.x / dq, qn1 = p.q.y / dq, kn0 = p.k.x / dk, kn1 = p.k.y / dk;
  p.XQ = make_float2(qn0 * p.c.x + (-qn1) * p.s.x, qn1 * p.c.y + qn0 * p.s.y);
  p.XK = make_float2(kn0 * p.c.x + (-kn1) * p.s.x, kn1 * p.c.y + kn0 * p.s.y);

  const float t0 = v.x - p.XK.x, t1 = v.y - p.XK.y;
  const float mu = warp_sum(t0 + t1) * (1.f / kF);
  const float d0 = t0 - mu, d1 = t1 - mu;
  const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) * ((float)kF / (kF - 1));
  p.sd = sqrtf(var) + 1e-8f;
  p.that = make_float2(d0 / p.sd, d1 / p.sd);
  p.tgt = make_float2(lw.x * p.that.x + lb.x, lw.y * p.that.y + lb.y);

  const float gl = a.gate[(((size_t)b * a.H + h) * a.NC + n) * kCS + r];
  p.sig = 1.f / (1.f + expf(-gl));
  p.eta = p.sig * a.eta_scale;
  return p;
}

// ln_fused_l2_bwd(x, target) of one row (eps 1e-8 on the biased variance),
// in the forward's form: (1/F) (F gx - sum gx - xh sum(gx xh)) / sd.
__device__ __forceinline__ float2 fused_l2_grad(float2 x, float2 tgt, float2 lw, float2 lb) {
  const float mu = warp_sum(x.x + x.y) * (1.f / kF);
  const float d0 = x.x - mu, d1 = x.y - mu;
  const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
  const float xh0 = d0 / sd, xh1 = d1 / sd;
  const float gx0 = (lw.x * xh0 + lb.x - tgt.x) * lw.x;
  const float gx1 = (lw.y * xh1 + lb.y - tgt.y) * lw.y;
  const float s1 = warp_sum(gx0 + gx1);
  const float s2 = warp_sum(gx0 * xh0 + gx1 * xh1);
  return make_float2((1.f / kF) * (kF * gx0 - s1 - xh0 * s2) / sd, (1.f / kF) * (kF * gx1 - s1 - xh1 * s2) / sd);
}

// ln_stats: (x - mu) / std with std = sqrt(biased var + 1e-8).
__device__ __forceinline__ float2 ln_stats(float2 x, float& sd) {
  const float mu = warp_sum(x.x + x.y) * (1.f / kF);
  const float d0 = x.x - mu, d1 = x.y - mu;
  sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
  return make_float2(d0 / sd, d1 / sd);
}

}  // namespace tttl
