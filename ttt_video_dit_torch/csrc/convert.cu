// float32 -> bfloat16 conversion of a weight (K7), for Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/convert.py:_convert_kernel (launched
// by _pallas_convert, reached through opaque_convert from
// models/dit/dit.py:_make_scan_param_pin), the elementwise cast of each
// transformer layer's 2-D Dense kernels to the compute dtype. On the TPU it is
// a fence against an XLA rewrite; in the port it is the cast of the layer
// stack's float32 master weights at each training forward.
//
// What bounds it on the H100: bytes. Each element is read once (4 bytes) and
// written once (2 bytes) and needs one conversion, so the bound is
// 6 bytes / 3.35 TB/s an element (68 us for a [12288, 3072] weight).
//
// Design: a grid-stride loop over groups of 8 elements: two 16-byte loads,
// one 16-byte store (the wrapper passes 16-byte aligned pointers; a tail of
// fewer than 8 elements goes element by element). Each value is rounded with
// __float2bfloat16_rn (round to nearest even; NaN stays NaN, values past the
// bf16 range become inf), the conversion PyTorch's own .to(torch.bfloat16)
// uses on this card, so the result is bit-identical to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) convert_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                                                           long long n) {
  const long long groups = n / 8;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < groups; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
    __nv_bfloat162 o[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                           __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
    reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(o);
  }
  for (long long i = groups * 8 + (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    y[i] = __float2bfloat16_rn(x[i]);
}

}  // namespace

extern "C" int convert_f32_bf16(const void* x, void* y, long long n, int num_sms, void* stream) {
  const long long groups = (n + 7) / 8;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 8LL * num_sms ? (blocks > 0 ? blocks : 1) : 8LL * num_sms);
  convert_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                                            static_cast<__nv_bfloat16*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
