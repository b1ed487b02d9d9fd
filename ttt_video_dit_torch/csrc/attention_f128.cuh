// The 128-wide rows of the head-dim-128 attention kernels
// (attention_forward_f128.cu, attention_backward_f128.cu): the 128-byte
// swizzle of hopper.cuh takes TMA boxes of at most 64 bf16 across, so every
// 128-wide tile is two 64-column halves, each its own box of one 4-D tensor
// map over [BC, S, H, 128], stored one after the other in shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn128 {

constexpr int kF = 128;
constexpr int kHalf = 64;  // bf16 columns of one 128-byte swizzle atom (one TMA box)

// A map of a [BC, S, H, 128] bf16 tensor (contiguous) whose box is ``rows``
// tokens of one head and window by 64 features (one half of a row), 128-byte
// swizzled; the half is chosen by the load's first coordinate (0 or 64).
// Reads past S are filled with zeros. Returns 0 or an error code.
inline int encode_half_rows_map(CUtensorMap* map, const void* base, int BC, int S, int H, int rows) {
  const hopper::EncodeTiled encode = hopper::encoder();
  if (encode == nullptr) return hopper::kNoEncoder;
  const cuuint64_t row_bytes = kF * 2;
  const cuuint64_t dims[4] = {kF, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)BC};
  const cuuint64_t strides[3] = {row_bytes, (cuuint64_t)H * row_bytes, (cuuint64_t)S * H * row_bytes};
  const cuuint32_t box[4] = {kHalf, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                              unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : hopper::kTensorMapError + static_cast<int>(res);
}

// Both halves of a 128-wide tile of ``rows`` rows at token ``row0`` into ``dst`` (half 1 ``half_bytes`` after half 0).
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int h, int row0,
                                          int bc, int half_bytes) {
  hopper::tma_load_4d(dst, map, bar, 0, h, row0, bc);
  hopper::tma_load_4d(dst + half_bytes, map, bar, kHalf, h, row0, bc);
}

}  // namespace attn128
