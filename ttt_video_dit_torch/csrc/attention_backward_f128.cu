// Window attention backward, head_dim 128 (K4@F128), for Hopper (sm_90a).
//
// Replaces: the splash-attention backward that ttt_video_dit_tpu/ops/attention.py
// runs through its custom VJP (_splash_kernel.call_bwd, l.326, into the
// library's _splash_attention_bwd dq/dkv kernels) at head dim 128 (d3072 at
// 24 heads), which the JAX package takes for bf16 windows whatever the head
// dim. It computes what attention_backward.cu computes at head dim 64: per
// attention window and head, from q, k, v, the forward's output o and
// log-sum-exp lse (written by attention_forward_f128.cu's training launch)
// and the output cotangent do,
//   D = rowsum(do * o), P = exp(q k^T * scale - lse),
//   dv = P^T do, dS = P * (do v^T - D), dq = dS k * scale, dk = dS^T q * scale.
//
// What bounds it on the H100: operations, as at head dim 64: 5 S^2 F
// multiply-adds per window and head on 7 S F bf16 inputs and outputs
// (S = 18,048 at the 3 s geometry), far above the ~295 flop/byte ridge.
//
// Design: attention_backward.cu's deterministic, non-fused form, reshaped
// for 128-wide rows; a source of its own, so the head-dim-64 kernels
// compile as before. dk and dv in one kernel that walks q for a kv tile, dq
// in one that walks kv for a q tile: each output element is one sum in
// registers in a fixed order (no atomics, nothing added across blocks), so
// the same inputs give the same bits on every launch; S and dP are computed
// twice (7 S^2 F multiply-adds of the function's 5). Every 128-wide tile is
// two 64-column TMA boxes (attention_f128.cuh). Three launches in the one C
// entry, all on the caller's stream:
//   1. attn_bwd_delta_f128: D per row, one warp per (token, head).
//   2. attn_bwd_dkv_f128: one block of three warpgroups per (window-batch,
//      head, 128-row kv tile):
//      - producer warpgroup (setmaxnreg down to 24). Warp 0, one thread: the
//        block's K and V tiles (128 x 128 each) once, then every 64-row q
//        tile's Q and dO into a ring of 3 stages by TMA. Warp 1: the tile's
//        lse (times log2 e; +inf past S) and D (0 past S) beside them.
//      - two consumer warpgroups (setmaxnreg up to 240), 64 kv rows each. At
//        head dim 64 the consumers held K and V as bf16 A fragments; at 128
//        that (64 registers) beside the dK and dV accumulators (128) and the
//        scores would pass 255, so K, V, Q and dO are all shared-memory
//        operands here. Per q tile: S^T = K Q^T and dP^T = V dO^T by wgmma
//        m64n64k16 over 8 k-steps (4 in each half of the features);
//        P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - D) in
//        fp32 registers; then dV += P^T dO and dK += dS^T Q by wgmma with P^T
//        and dS^T as bf16 A fragments, once per 64-column half of dO and Q
//        (MN-major B) into two accumulators each. The tile's products run one
//        after the other (no overlap between q tiles: dK, dV 128 + S^T, dP^T
//        64 + P^T, dS^T 32 registers would leave the compiler nothing).
//      Shared memory: K, V 64 KiB + 3 stages x 32.5 KiB, ~163 KiB.
//   3. attn_bwd_dq_f128: one block of three warpgroups per (window-batch,
//      head, 128-row q tile): a producer thread loads the Q and dO tiles
//      once and every 128-row K and V tile into a ring of 2 stages; two
//      consumer warpgroups (240 registers) hold their rows' lse and D and,
//      per 64-row half of a kv tile, compute S = Q K^T and dP = dO V^T
//      (shared-memory operands), P = exp2(S scale log2 e - lse log2 e) (0
//      past S), dS = P (dP - D), and dq += dS K into two 64-column
//      accumulators (dS as bf16 A fragments, K MN-major), the product of
//      half u - 1 running while half u's dS is computed; at the end
//      dq = bf16(dq * scale). Shared memory: Q, dO 64 KiB + 2 stages x
//      64 KiB, ~193 KiB. Registers per consumer thread: dq 64, S, dP 32
//      each, dS 16.
// P (for dV) and dS (for dK, dQ) are rounded to bf16 as operands, as the
// forward rounds P; D, lse and every sum stay fp32. KV rows >= S get P = 0 and
// q rows >= S get P = 0 (lse = +inf), so the ragged edge needs no padding.
//
// Layouts: q/k/v/o/do/dq/dk/dv [BC, S, H, 128] bf16; lse, delta [BC, H, S] f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_f128.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using attn128::kF;
using attn128::kHalf;
using attn128::load_tile;

constexpr int kBlockKV = 128;  // kv rows per dkv block (two consumer warpgroups x 64) and per dq ring stage
constexpr int kBlockQ = 64;    // q rows per dkv ring stage
constexpr int kStages = 3;     // the dkv ring
constexpr int kThreads = 384;  // a producer and two consumer warpgroups, in both kernels
constexpr int kKVHalfBytes = kBlockKV * kHalf * 2;  // one 64-column half of the K (or V) tile
constexpr int kKVBytes = 2 * kKVHalfBytes;
constexpr int kQHalfBytes = kBlockQ * kHalf * 2;    // one half of a Q (or dO) stage of the dkv ring
constexpr int kQBytes = 2 * kQHalfBytes;
constexpr int kSmemBytes = 1024 + 2 * kKVBytes + 2 * kStages * kQBytes + kStages * 2 * kBlockQ * 4 +
                           8 * (1 + 2 * kStages);
constexpr int kDqBlockQ = 128;  // q rows per dq block: two consumer warpgroups x 64
constexpr int kDqStages = 2;    // the dq ring of K and V tiles
constexpr int kDqQHalfBytes = kDqBlockQ * kHalf * 2;
constexpr int kDqQBytes = 2 * kDqQHalfBytes;
constexpr int kDqSmemBytes = 1024 + 2 * kDqQBytes + 2 * kDqStages * kKVBytes + 8 * (1 + 2 * kDqStages);
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSmemBytes <= 232448 && kDqSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");

// D[bc, h, s] = sum_f do[bc, s, h, f] * o[bc, s, h, f]; one warp per (bc, s, h), 4 features a lane.
__global__ void __launch_bounds__(256)
attn_bwd_delta_f128(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                    float* __restrict__ delta, int S, int H, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t off = (size_t)row * kF + lane * 4;
  const uint2 ou = *reinterpret_cast<const uint2*>(o + off), du = *reinterpret_cast<const uint2*>(dout + off);
  const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ou.x));
  const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ou.y));
  const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&du.x));
  const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&du.y));
  float s = a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const long long bc = row / ((long long)S * H), rem = row % ((long long)S * H);
    const int tok = (int)(rem / H), h = (int)(rem % H);
    delta[((size_t)bc * H + h) * S + tok] = s;
  }
}

// Store columns c0 .. c0 + 63 of a warpgroup's accumulator tile (rows r0, r0 + 8 of the lane) times ``mul`` as
// bf16; rows >= S skipped.
__device__ __forceinline__ void store_half(__nv_bfloat16* base, size_t rs, const float (&acc)[32], int r0, int S,
                                           int c0, int t4, float mul) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + i * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(base + r0 * rs + c) = pack_bf16(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * rs + c) =
          pack_bf16(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
}

// x = A X^T and y = B Y^T over the 128 features, 64 x 64 each, one wgmma group: A and B the warpgroup's 64 rows
// and X, Y 64 rows of the other side, all K-major in shared memory; *0 the descriptors of the first 64-feature
// half, *1 of the second.
__device__ __forceinline__ void issue_scores(float (&x)[32], float (&y)[32], uint64_t a0, uint64_t a1, uint64_t x0,
                                             uint64_t x1, uint64_t b0, uint64_t b1, uint64_t y0, uint64_t y1) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(x, a0 + 2 * kk, x0 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(x, a1 + 2 * kk, x1 + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(y, b0 + 2 * kk, y0 + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(y, b1 + 2 * kk, y1 + 2 * kk, 1);
  wgmma_commit();
}

// acc_c += a Y_c for both 64-column halves c of a 64-row MN-major B (16 rows = 2048 bytes a k-step), a the bf16
// A fragments of a 64 x 64 tile; no commit.
__device__ __forceinline__ void mma_halves(float (&acc0)[32], float (&acc1)[32], const uint32_t (&a)[16],
                                           uint64_t y0, uint64_t y1) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(acc0, &a[4 * kk], y0 + 128 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(acc1, &a[4 * kk], y1 + 128 * kk, 1);
}

// P^T and dS^T of one q tile in place of S^T (s) and dP^T (dp): the lane's kv rows are inside the window where
// in0 / in1; L, D are the tile's 64 q columns' lse log2 e and D.
__device__ __forceinline__ void dkv_probs(float (&s)[32], float (&dp)[32], const float* L, const float* D, bool in0,
                                          bool in1, int t4, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = i * 8 + t4 * 2 + (e & 1);
      const float p = (e < 2 ? in0 : in1) ? exp2_ftz(fmaf(s[4 * i + e], scale_log2, -L[col])) : 0.f;
      dp[4 * i + e] = p * (dp[4 * i + e] - D[col]);
      s[4 * i + e] = p;
    }
}

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv_f128(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;  // half 0 (features 0-63), then half 1, kKVHalfBytes apart
  uint8_t* Vs = Ks + kKVBytes;
  uint8_t* Qs = Vs + kKVBytes;  // stage s at s * kQBytes, its halves kQHalfBytes apart
  uint8_t* dOs = Qs + kStages * kQBytes;
  float* Ls = reinterpret_cast<float*>(dOs + kStages * kQBytes);  // [stage][64] lse * log2 e
  float* Dl = Ls + kStages * kBlockQ;                             // [stage][64] D
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Dl + kStages * kBlockQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, bc = blockIdx.z, kv0 = blockIdx.x * kBlockKV;
  const int nq = (S + kBlockQ - 1) / kBlockQ;

  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tdo);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * kKVBytes);
      load_tile(Ks, &tk, kv_full, h, kv0, bc, kKVHalfBytes);
      load_tile(Vs, &tv, kv_full, h, kv0, bc, kKVHalfBytes);
      for (int j = 0; j < nq; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kQBytes);
        load_tile(Qs + s * kQBytes, &tq, &full[s], h, j * kBlockQ, bc, kQHalfBytes);
        load_tile(dOs + s * kQBytes, &tdo, &full[s], h, j * kBlockQ, bc, kQHalfBytes);
      }
    } else if (tid >= 32 && tid < 64) {
      const int lane = tid - 32;
      const float* lse_b = lse + ((size_t)bc * H + h) * S;
      const float* del_b = delta + ((size_t)bc * H + h) * S;
      for (int j = 0; j < nq; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        for (int r = lane; r < kBlockQ; r += 32) {
          const int q = j * kBlockQ + r;
          Ls[s * kBlockQ + r] = q < S ? lse_b[q] * kLog2e : INFINITY;
          Dl[s * kBlockQ + r] = q < S ? del_b[q] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroups: cw owns kv rows kv0 + 64 cw .. + 63; each lane holds rows kr0 = that + 16 warp + g and
  // kr0 + 8 of the wgmma accumulators (columns 8 i + 2 t4 + {0, 1} of n8 block i).
  reg_alloc<240>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const int kr0 = kv0 + cw * 64 + warp * 16 + g;
  const bool in0 = kr0 < S, in1 = kr0 + 8 < S;
  const int wg_off = cw * 64 * 128;  // the warpgroup's 64 rows within a 128-row half
  const uint64_t kd0 = desc_sw128(Ks + wg_off), kd1 = desc_sw128(Ks + kKVHalfBytes + wg_off);
  const uint64_t vd0 = desc_sw128(Vs + wg_off), vd1 = desc_sw128(Vs + kKVHalfBytes + wg_off);

  float dk0[32], dk1[32], dv0[32], dv1[32], sacc[32], dpacc[32];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = dk1[i] = dv0[i] = dv1[i] = sacc[i] = dpacc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int j = 0; j < nq; ++j) {
    const int st = j % kStages;
    const uint8_t* q = Qs + st * kQBytes;
    const uint8_t* d = dOs + st * kQBytes;
    const uint64_t qd0 = desc_sw128(q), qd1 = desc_sw128(q + kQHalfBytes);
    const uint64_t dd0 = desc_sw128(d), dd1 = desc_sw128(d + kQHalfBytes);
    mbar_wait(&full[st], (j / kStages) & 1);
    issue_scores(sacc, dpacc, kd0, kd1, qd0, qd1, vd0, vd1, dd0, dd1);  // S^T = K Q^T, dP^T = V dO^T
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);
    dkv_probs(sacc, dpacc, Ls + st * kBlockQ, Dl + st * kBlockQ, in0, in1, t4, scale_log2);
    acc_to_a(pa, sacc);
    acc_to_a(da, dpacc);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    mma_halves(dv0, dv1, pa, dd0, dd1);  // dV += P^T dO
    mma_halves(dk0, dk1, da, qd0, qd1);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv0);
    fence_regs(dv1);
    fence_regs(dk0);
    fence_regs(dk1);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  const size_t rs = (size_t)H * kF;
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  store_half(dk + base, rs, dk0, kr0, S, 0, t4, scale);
  store_half(dk + base, rs, dk1, kr0, S, kHalf, t4, scale);
  store_half(dv + base, rs, dv0, kr0, S, 0, t4, 1.f);
  store_half(dv + base, rs, dv1, kr0, S, kHalf, t4, 1.f);
}

// dS of one 64-row half of a kv tile in place of dP (dp), from the raw scores s: kv columns from ``left`` on lie
// past S; L0 / L1 and D0 / D1 are the lse log2 e and D of the lane's q rows.
__device__ __forceinline__ void dq_probs(const float (&s)[32], float (&dp)[32], int left, float L0, float L1,
                                         float D0, float D1, int t4, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = i * 8 + t4 * 2 + (e & 1);
      const float p = col < left ? exp2_ftz(fmaf(s[4 * i + e], scale_log2, -(e < 2 ? L0 : L1))) : 0.f;
      dp[4 * i + e] = p * (dp[4 * i + e] - (e < 2 ? D0 : D1));
    }
}

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_f128(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                 int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;  // half 0, then half 1, kDqQHalfBytes apart
  uint8_t* dOs = Qs + kDqQBytes;
  uint8_t* Ks = dOs + kDqQBytes;  // stage s at s * kKVBytes, its halves kKVHalfBytes apart
  uint8_t* Vs = Ks + kDqStages * kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kDqStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, bc = blockIdx.z, q0 = blockIdx.x * kDqBlockQ;
  const int n_tiles = (S + kBlockKV - 1) / kBlockKV;

  if (tid == 0) {
    prefetch_map(&tq);
    prefetch_map(&tdo);
    prefetch_map(&tk);
    prefetch_map(&tv);
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * kDqQBytes);
      load_tile(Qs, &tq, q_full, h, q0, bc, kDqQHalfBytes);
      load_tile(dOs, &tdo, q_full, h, q0, bc, kDqQHalfBytes);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&empty[s], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        load_tile(Ks + s * kKVBytes, &tk, &full[s], h, j * kBlockKV, bc, kKVHalfBytes);
        load_tile(Vs + s * kKVBytes, &tv, &full[s], h, j * kBlockKV, bc, kKVHalfBytes);
      }
    }
    return;
  }

  // Consumer warpgroups: cw owns q rows q0 + 64 cw .. + 63; each lane holds rows r0 = that + 16 warp + g and
  // r0 + 8 of the accumulators.
  reg_alloc<240>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const int r0 = q0 + cw * 64 + warp * 16 + g;
  const float* lse_b = lse + ((size_t)bc * H + h) * S;
  const float* del_b = delta + ((size_t)bc * H + h) * S;
  const float L0 = r0 < S ? lse_b[r0] * kLog2e : INFINITY, L1 = r0 + 8 < S ? lse_b[r0 + 8] * kLog2e : INFINITY;
  const float D0 = r0 < S ? del_b[r0] : 0.f, D1 = r0 + 8 < S ? del_b[r0 + 8] : 0.f;
  const int wg_off = cw * 64 * 128;
  const uint64_t qd0 = desc_sw128(Qs + wg_off), qd1 = desc_sw128(Qs + kDqQHalfBytes + wg_off);
  const uint64_t dd0 = desc_sw128(dOs + wg_off), dd1 = desc_sw128(dOs + kDqQHalfBytes + wg_off);
  // Half u of the kv tiles: rows 64 u .. 64 u + 63, in stage (u / 2) % kDqStages at row 64 (u % 2); feature half c.
  auto half = [&](const uint8_t* tiles, int u, int c) {
    return desc_sw128(tiles + ((u >> 1) % kDqStages) * kKVBytes + c * kKVHalfBytes + (u & 1) * 64 * 128);
  };

  float dq0[32], dq1[32], sacc[32], dpacc[32];
  uint32_t dsa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq0[i] = dq1[i] = sacc[i] = dpacc[i] = 0.f;
  mbar_wait(q_full, 0);

  // Half 0 alone, then every half u issues its scores and half u - 1's dq product together, so the number of
  // wgmma groups in flight is the same at every wait.
  const int halves = 2 * n_tiles;
  mbar_wait(&full[0], 0);
  issue_scores(sacc, dpacc, qd0, qd1, half(Ks, 0, 0), half(Ks, 0, 1), dd0, dd1, half(Vs, 0, 0), half(Vs, 0, 1));
  wgmma_wait<0>();
  fence_regs(sacc);
  fence_regs(dpacc);
  dq_probs(sacc, dpacc, S, L0, L1, D0, D1, t4, scale_log2);
  acc_to_a(dsa, dpacc);
  for (int u = 1; u < halves; ++u) {
    if ((u & 1) == 0) mbar_wait(&full[(u >> 1) % kDqStages], ((u >> 1) / kDqStages) & 1);
    issue_scores(sacc, dpacc, qd0, qd1, half(Ks, u, 0), half(Ks, u, 1), dd0, dd1, half(Vs, u, 0), half(Vs, u, 1));
    fence_regs(dsa);
    wgmma_fence();
    mma_halves(dq0, dq1, dsa, half(Ks, u - 1, 0), half(Ks, u - 1, 1));  // dq += dS K
    wgmma_commit();
    wgmma_wait<1>();  // the scores of half u are in; dq of half u - 1 may still run
    fence_regs(sacc);
    fence_regs(dpacc);
    dq_probs(sacc, dpacc, S - u * 64, L0, L1, D0, D1, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(dsa);
    if ((u & 1) == 0 && lane == 0) mbar_arrive(&empty[((u >> 1) - 1) % kDqStages]);  // both halves of tile u/2 - 1 done
    acc_to_a(dsa, dpacc);
  }
  fence_regs(dsa);
  wgmma_fence();
  mma_halves(dq0, dq1, dsa, half(Ks, halves - 1, 0), half(Ks, halves - 1, 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq0);
  fence_regs(dq1);

  const size_t rs = (size_t)H * kF;
  __nv_bfloat16* dqb = dq + (size_t)bc * S * rs + (size_t)h * kF;
  store_half(dqb, rs, dq0, r0, S, 0, t4, scale);
  store_half(dqb, rs, dq1, r0, S, kHalf, t4, scale);
}

}  // namespace

extern "C" int attention_backward_f128_smem_bytes() { return kSmemBytes > kDqSmemBytes ? kSmemBytes : kDqSmemBytes; }

extern "C" int attention_backward_f128(const void* q, const void* k, const void* v, const void* o, const void* lse,
                                       const void* dout, void* dq, void* dk, void* dv, void* delta, int BC, int S,
                                       int H, float scale, void* stream) {
  using attn128::encode_half_rows_map;
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tdo, tk, tv, tq_dq, tdo_dq;
  int err = encode_half_rows_map(&tq, q, BC, S, H, kBlockQ);
  if (err == 0) err = encode_half_rows_map(&tdo, dout, BC, S, H, kBlockQ);
  if (err == 0) err = encode_half_rows_map(&tk, k, BC, S, H, kBlockKV);
  if (err == 0) err = encode_half_rows_map(&tv, v, BC, S, H, kBlockKV);
  if (err == 0) err = encode_half_rows_map(&tq_dq, q, BC, S, H, kDqBlockQ);
  if (err == 0) err = encode_half_rows_map(&tdo_dq, dout, BC, S, H, kDqBlockQ);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(attn_bwd_dkv_f128, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(attn_bwd_dq_f128, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  auto* delta_ = static_cast<float*>(delta);
  const auto* lse_ = static_cast<const float*>(lse);
  const long long rows = (long long)BC * S * H;
  attn_bwd_delta_f128<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                                                   static_cast<const __nv_bfloat16*>(dout), delta_, S,
                                                                   H, rows);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  attn_bwd_dkv_f128<<<dim3((S + kBlockKV - 1) / kBlockKV, H, BC), kThreads, kSmemBytes, st>>>(
      tq, tdo, tk, tv, lse_, delta_, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, scale);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  attn_bwd_dq_f128<<<dim3((S + kDqBlockQ - 1) / kDqBlockQ, H, BC), kThreads, kDqSmemBytes, st>>>(
      tq_dq, tdo_dq, tk, tv, lse_, delta_, static_cast<__nv_bfloat16*>(dq), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return hopper::error_string(err); }
