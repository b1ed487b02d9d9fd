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
// Design: one block per tile of 4,096 elements (16 KiB in, 8 KiB out), so
// the blocks resident at any moment stream neighbouring addresses. A thread
// converts two groups of 8 consecutive elements: it issues all four of its
// 16-byte loads (64 bytes) before its first conversion and writes each group
// with one 16-byte store; the elements past the last whole tile go one by
// one. Each value is rounded with __float2bfloat16_rn (round to nearest
// even; NaN stays NaN, values past the bf16 range become inf), the
// conversion PyTorch's own .to(torch.bfloat16) uses on this card, so the
// result is bit-identical to it. Tried and measured slower on the H100
// (PERF.md): a grid of whole waves from the occupancy API with a contiguous
// run of tiles a block, with a grid-stride run, loads that bypass L1
// (ld.global.nc.L1::no_allocate) and evict-first stores (st.global.cs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;                      // groups of 8 elements a thread converts
constexpr int kTile = kThreads * 8 * kGroups;   // elements a block converts

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads) convert_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ y,
                                                           long long n) {
  const long long tiles = n / kTile;
  if (blockIdx.x < tiles) {
    const long long base = (long long)blockIdx.x * kTile + threadIdx.x * 8;
    float4 v[2 * kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      v[2 * j] = *reinterpret_cast<const float4*>(x + base + j * kThreads * 8);
      v[2 * j + 1] = *reinterpret_cast<const float4*>(x + base + j * kThreads * 8 + 4);
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float4 a = v[2 * j], b = v[2 * j + 1];
      *reinterpret_cast<uint4*>(y + base + j * kThreads * 8) =
          make_uint4(pack(a.x, a.y), pack(a.z, a.w), pack(b.x, b.y), pack(b.z, b.w));
    }
  }
  for (long long i = tiles * kTile + (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    y[i] = __float2bfloat16_rn(x[i]);
}

}  // namespace

// ``num_sms`` is not used: the grid is one block per tile.
extern "C" int convert_f32_bf16(const void* x, void* y, long long n, int num_sms, void* stream) {
  const long long tiles = n / kTile;
  const int grid = (int)(tiles > 0 ? tiles : 1);
  convert_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                                            static_cast<__nv_bfloat16*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
