// Window attention backward, head_dim 64, for Hopper (sm_90a).
//
// Replaces: the splash-attention backward that ttt_video_dit_tpu/ops/attention.py
// runs through its custom VJP (_splash_kernel.call_bwd, l.326, into the
// library's _splash_attention_bwd dq/dkv kernels). Per attention window and
// head, from q, k, v, the forward's output o and log-sum-exp lse (written by
// csrc/attention_forward.cu) and the output cotangent do, it computes
//   P = exp(q k^T * scale - lse), D = rowsum(do * o),
//   dv = P^T do, dS = P * (do v^T - D), dq = dS k * scale, dk = dS^T q * scale.
//
// What bounds it on the H100: arithmetic. Per window and head the two main
// kernels below do 7 S^2 F multiply-adds (S = 18,048 at the 3 s geometry)
// on 7 S F bf16 inputs and outputs, far above the ~295 flop/byte ridge; the
// tensor cores set the limit.
//
// Design: three launches, no atomics, nothing padded.
//   1. attn_bwd_delta: D per row, one warp per (token, head).
//   2. attn_bwd_dkdv: one block of 4 warps per (window-batch, head, 64-row KV
//      tile); each warp keeps its 16 K rows and 16 V rows as mma.sync A
//      fragments, walks 64-row Q/dO tiles staged in shared memory, rebuilds
//      P^T = exp(K Q^T * scale - lse) and dP^T = V dO^T in registers, and
//      accumulates dV += P^T dO and dK += dS^T Q in fp32 registers.
//   3. attn_bwd_dq: one block per 64-row Q tile, the forward's loop shape:
//      Q and dO rows stay as A fragments, K/V tiles are staged, and
//      dQ += dS K accumulates in registers.
// The QK^T product is therefore done twice (once per kernel) instead of
// once with fp32 atomics for dQ. Products run on mma.sync m16n8k16 bf16 ->
// fp32; P (for dV) and dS (for dK, dQ) are rounded to bf16 as operands, as
// the forward rounds P; D, lse and every sum stay fp32. KV columns >= S get
// P = 0 and q rows >= S get P = 0, so the ragged edge needs no padding.
// Not yet done (later work): wgmma, TMA, double-buffered tiles, ldmatrix,
// one fused dq/dkv pass.
//
// Layouts: q/k/v/o/do/dq/dk/dv [BC, S, H, 64] bf16; lse, delta [BC, H, S] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using namespace attn;

// Store an accumulator tile (rows r0, r0 + 8) times ``mul`` as bf16; rows >= S skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t rs, const float (&acc)[8][4], int r0, int S,
                                           int t4, float mul) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = nt * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(base + r0 * rs + c) = pack_bf16(acc[nt][0] * mul, acc[nt][1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * rs + c) = pack_bf16(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

// D[bc, h, s] = sum_f do[bc, s, h, f] * o[bc, s, h, f]; one warp per (bc, s, h).
__global__ void __launch_bounds__(256)
attn_bwd_delta(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
               float* __restrict__ delta, int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t off = (size_t)row * kF + lane * 2;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off));
  float s = a.x * b.x + a.y * b.y;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long long bc = row / ((long long)S * H), rem = row % ((long long)S * H);
    const int tok = (int)(rem / H), h = (int)(rem % H);
    delta[((size_t)bc * H + h) * S + tok] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int S, int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 Ds[kBM * kLds];  // the dO tile
  __shared__ float Ls[kBM], Dl[kBM];                      // lse * log2(e) and D of the tile's q rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, bc = blockIdx.z;
  const size_t rs = (size_t)H * kF;
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  const float* lse_b = lse + ((size_t)bc * H + h) * S;
  const float* del_b = delta + ((size_t)bc * H + h) * S;
  const float scale_log2 = scale * kLog2e;

  const int r0 = blockIdx.x * kBM + warp * 16 + g;  // this lane's kv rows r0, r0 + 8
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, k + base, rs, r0, S, t4);
  load_a_frags(va, v + base, rs, r0, S, t4);

  float dkacc[8][4], dvacc[8][4];
  zero(dkacc);
  zero(dvacc);

  for (int q0 = 0; q0 < S; q0 += kBM) {
    __syncthreads();  // the previous tile's readers are done
    stage_tiles(Qs, Ds, q + base, dout + base, rs, q0, S, tid);
    if (tid < kBM) {
      const bool in = q0 + tid < S;
      Ls[tid] = in ? lse_b[q0 + tid] * kLog2e : 0.f;
      Dl[tid] = in ? del_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    // P^T = exp(K Q^T * scale - lse[q]) and dP^T = V dO^T, 16 kv rows x 64 q columns.
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    mma_a_bt(p, ka, Qs, g, t4);
    mma_a_bt(dp, va, Ds, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + t4 * 2 + (j & 1);
        const float pv = q0 + col < S ? exp2f(p[nt][j] * scale_log2 - Ls[col]) : 0.f;
        p[nt][j] = pv;
        dp[nt][j] = pv * (dp[nt][j] - Dl[col]);  // dS^T
      }
    mma_x_b(dvacc, p, Ds, g, t4);   // dV += P^T dO
    mma_x_b(dkacc, dp, Qs, g, t4);  // dK += dS^T Q
  }
  store_rows(dk + base, rs, dkacc, r0, S, t4, scale);
  store_rows(dv + base, rs, dvacc, r0, S, t4, 1.f);
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
            int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBM * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.y, bc = blockIdx.z;
  const size_t rs = (size_t)H * kF;
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  const float* lse_b = lse + ((size_t)bc * H + h) * S;
  const float* del_b = delta + ((size_t)bc * H + h) * S;
  const float scale_log2 = scale * kLog2e;

  const int r0 = blockIdx.x * kBM + warp * 16 + g;  // this lane's q rows r0, r0 + 8
  const int r1 = r0 + 8;
  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, q + base, rs, r0, S, t4);
  load_a_frags(da, dout + base, rs, r0, S, t4);
  const float l0 = r0 < S ? lse_b[r0] * kLog2e : 0.f, l1 = r1 < S ? lse_b[r1] * kLog2e : 0.f;
  const float d0 = r0 < S ? del_b[r0] : 0.f, d1 = r1 < S ? del_b[r1] : 0.f;

  float dqacc[8][4];
  zero(dqacc);
  for (int kv0 = 0; kv0 < S; kv0 += kBM) {
    __syncthreads();
    stage_tiles(Ks, Vs, k + base, v + base, rs, kv0, S, tid);
    __syncthreads();

    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    mma_a_bt(p, qa, Ks, g, t4);   // S = Q K^T
    mma_a_bt(dp, da, Vs, g, t4);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool lo = j < 2;
        const bool in = kv0 + nt * 8 + t4 * 2 + (j & 1) < S;
        const float pv = in ? exp2f(p[nt][j] * scale_log2 - (lo ? l0 : l1)) : 0.f;
        dp[nt][j] = pv * (dp[nt][j] - (lo ? d0 : d1));  // dS
      }
    mma_x_b(dqacc, dp, Ks, g, t4);  // dQ += dS K
  }
  store_rows(dq + base, rs, dqacc, r0, S, t4, scale);
}

}  // namespace

extern "C" int attention_backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk, void* dv, void* delta, int BC, int S, int H,
                                  float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* q_ = static_cast<const __nv_bfloat16*>(q);
  const auto* k_ = static_cast<const __nv_bfloat16*>(k);
  const auto* v_ = static_cast<const __nv_bfloat16*>(v);
  const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
  const auto* lse_ = static_cast<const float*>(lse);
  auto* delta_ = static_cast<float*>(delta);
  const long long rows = (long long)BC * S * H;
  attn_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o), do_, delta_, S,
                                                              H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + attn::kBM - 1) / attn::kBM, H, BC);
  attn_bwd_dkdv<<<grid, attn::kThreads, 0, st>>>(q_, k_, v_, do_, lse_, delta_, static_cast<__nv_bfloat16*>(dk),
                                           static_cast<__nv_bfloat16*>(dv), S, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq<<<grid, attn::kThreads, 0, st>>>(q_, k_, v_, do_, lse_, delta_, static_cast<__nv_bfloat16*>(dq), S, H,
                                         scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
