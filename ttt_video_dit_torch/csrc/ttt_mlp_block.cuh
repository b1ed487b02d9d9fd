// Scalar helpers shared by the TTT kernels (ttt_mlp_forward.cu,
// ttt_mlp_backward.cu; the TTT-linear kernels, through ttt_linear_step.cuh,
// take only ScanArgs and with_slabs): bf16 rounding, warp sums, the tanh
// GELU and its first two derivatives, the per-step inputs of one scan, and
// the dispatch on the mini-batch. The TTT-MLP training step itself (CS
// 8-64, on the tensor cores) is in ttt_mlp_train_step.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace tttb {

// 16-token slabs (m16 tiles) of a mini-batch of cs tokens, cs a multiple of 8: the tiles of a step hold 16 NS
// rows. At a cs that is not a multiple of 16 the last slab is a half slab: rows 8..15 of its tile are padding,
// which the kernels never load or store and which add nothing to a sum over tokens (eta is 0 there).
__host__ __device__ constexpr int slabs(int cs) { return (cs + 15) / 16; }

// Call fn(std::integral_constant<int, CS>) for mini-batch cs; an error code for a CS the kernels are not built
// for. These cases are the instantiations of every TTT kernel built on 16-token slabs (ttt_linear_step.cuh,
// ttt_mlp_train_step.cuh), the lists ops/ttt_linear_kernel.py and ops/ttt_mlp_kernel.py name
// KERNEL_MINI_BATCHES.
template <typename Fn>
inline int with_slabs(int cs, Fn&& fn) {
  switch (cs) {
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 24: return fn(std::integral_constant<int, 24>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 40: return fn(std::integral_constant<int, 40>{});
    case 48: return fn(std::integral_constant<int, 48>{});
    case 56: return fn(std::integral_constant<int, 56>{});
    case 64: return fn(std::integral_constant<int, 64>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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

// gelu(x) and gelu'(x) from one tanh (the expressions of gelu_tanh and gelu_bwd).
__device__ __forceinline__ float gelu_and_grad(float x, float& grad) {
  const float t = tanhf(0.79788456f * x * (1.f + 0.044715f * x * x));
  grad = 0.5f * x * ((1.f - t * t) * (0.79788456f + 0.1070322243f * x * x)) + 0.5f * (1.f + t);
  return 0.5f * x * (1.f + t);
}

__device__ __forceinline__ float gelu_bwd2(float x) {
  const float a = 0.79788456f, c3 = 0.1070322243f;
  const float T = tanhf(a * x + (c3 / 3.f) * x * x * x);
  const float up = a + c3 * x * x, upp = 2.f * c3 * x;
  return (1.f - T * T) * (up + 0.5f * x * (upp - 2.f * T * up * up));
}

// The per-step inputs and parameters of one (batch, head) scan.
struct ScanArgs {
  const __nv_bfloat16 *xq, *xk, *xv;  // [B, NC, CS, H*F]
  const float* gate;                  // [B, H, NC, CS] pre-sigmoid logits
  const float *cos, *sin;             // [NC, CS, F]
  int NC, H;
  float eta_scale;
};

}  // namespace tttb
