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
// What bounds it on the H100: operations. The function needs 5 S^2 F
// multiply-adds per window and head (S = 18,048 at the 3 s geometry: K Q^T,
// V dO^T, P^T dO, dS^T Q, dS K) on 7 S F bf16 inputs and outputs, far above
// the ~295 flop/byte ridge; the tensor cores set the limit, the S^2
// exponentials come next.
//
// Design: the JAX package's non-fused form (block_q_dq beside the dkv
// kernel): dk and dv in one kernel that walks q for a kv tile, dq in one of
// its own that walks kv for a q tile. Each output element is then one sum in
// registers, in a fixed order, so the same inputs give the same bits on every
// launch; no output is added into across blocks. The price is S and dP
// computed twice: 7 S^2 F multiply-adds instead of 5. (Every kv tile adding
// its share of dq into one float32 accumulator lets the L2 add in whatever
// order blocks arrive, so dq would differ between runs in its last bits.
// Per-block partial sums summed afterwards in a fixed order need a block to
// own each partial: at the 3 s shape each of 1.9 million 16 KB adds would
// then miss the L2, ~62 GB to device memory, ~19 ms at 3.35 TB/s.) Three
// launches in the one C entry, all on the caller's stream:
//   1. attn_bwd_delta: D per row, one warp per (token, head).
//   2. attn_bwd_dkv: one block of three warpgroups per (window-batch, head,
//      128-row kv tile), on TMA, mbarriers and wgmma (hopper.cuh):
//      - producer warpgroup (setmaxnreg down to 40). Warp 0, one thread: the
//        block's K and V tiles (128 x 64 each) once, then every 64-row q tile's
//        Q and dO into a ring of 4 stages by TMA (4-D tensor maps, 128-byte
//        swizzle, zeros past S). Warp 1: the tile's lse (times log2 e; +inf
//        past S) and D (0 past S) beside them. A stage's "full" mbarrier waits
//        for the TMA bytes and warp 1's 32 arrivals, its "empty" one for every
//        consumer warp.
//      - two consumer warpgroups (setmaxnreg up to 232), 64 kv rows each. Per
//        q tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (the
//        warpgroup's K and V rows as bf16 A fragments in registers, read once
//        from the swizzled tiles; Q, dO as K-major B in shared memory);
//        P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T - D)
//        in fp32 registers; dV += P^T dO and dK += dS^T Q by wgmma with P^T and
//        dS^T as bf16 A fragments and dO, Q as MN-major B. The dV/dK products
//        of q tile j - 1 are issued right after the scores of tile j and run
//        while tile j's P^T and dS^T are computed (two wgmma groups in flight;
//        tile 0 is peeled so that every wait sees the same groups).
//      Shared memory: K, V 32 KB + 4 stages x 16.5 KB (Q, dO, lse, D), about
//      99 KB, dynamic. Registers per consumer thread: dK, dV, S^T, dP^T 32
//      each, K, V, P^T, dS^T 16 each as bf16.
//   3. attn_bwd_dq: one block of three warpgroups per (window-batch, head,
//      128-row q tile): a producer thread loads the Q and dO tiles once and
//      every 128-row K and V tile into a ring of 3 stages (TMA, as above); two
//      consumer warpgroups (setmaxnreg up to 232) hold their 64 Q and dO rows
//      as bf16 A fragments and their rows' lse and D in registers, and per
//      64-row half of a kv tile compute S = Q K^T and dP = dO V^T by wgmma,
//      P = exp2(S scale log2 e - lse log2 e) (0 past S), dS = P (dP - D),
//      and dq += dS K (dS as bf16 A fragments, K as MN-major B), the product
//      of half u - 1 running while half u's dS is computed; at the end
//      dq = bf16(dq * scale). Shared memory: Q, dO 32 KB + 3 stages x 32 KB,
//      about 129 KB. Registers per consumer thread: dq, S, dP 32 each, Q, dO,
//      dS 16 each.
// P (for dV) and dS (for dK, dQ) are rounded to bf16 as operands, as the
// forward rounds P; D, lse and every sum stay fp32. KV rows >= S get P = 0 and
// q rows >= S get P = 0 (lse = +inf), so the ragged edge needs no padding.
//
// Layouts: q/k/v/o/do/dq/dk/dv [BC, S, H, 64] bf16; lse, delta [BC, H, S] f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kF = 64;
constexpr int kBlockKV = 128;  // kv rows per dkv block (two consumer warpgroups x 64) and per dq ring stage
constexpr int kBlockQ = 64;    // q rows per dkv ring stage
constexpr int kStages = 4;     // the dkv ring
constexpr int kThreads = 384;  // a producer and two consumer warpgroups, in both kernels
constexpr int kKVBytes = kBlockKV * kF * 2;  // the K (or V) tile
constexpr int kQBytes = kBlockQ * kF * 2;    // one Q (or dO) stage of the dkv ring
constexpr int kSmemBytes = 1024 + 2 * kKVBytes + 2 * kStages * kQBytes + kStages * 2 * kBlockQ * 4 +
                           8 * (1 + 2 * kStages);
constexpr int kDqBlockQ = 128;  // q rows per dq block: two consumer warpgroups x 64
constexpr int kDqStages = 3;    // the dq ring of K and V tiles
constexpr int kDqQBytes = kDqBlockQ * kF * 2;
constexpr int kDqSmemBytes = 1024 + 2 * kDqQBytes + 2 * kDqStages * kKVBytes + 8 * (1 + 2 * kDqStages);
constexpr float kLog2e = 1.4426950408889634f;

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

// The A fragments (bf16, k-step kk in a[4 kk .. 4 kk + 3]) of the 64 x 64
// tile at ``tile`` (128-byte swizzled rows) for the lane's rows r0 = 16 warp
// + g and r0 + 8 and columns 16 kk + 2 t4 (+ 8).
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[16], const uint8_t* tile, int r0, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = r0 + (x & 1) * 8, chunk = 2 * kk + (x >> 1);
      a[4 * kk + x] = *reinterpret_cast<const uint32_t*>(tile + r * 128 + ((chunk ^ (r & 7)) << 4) + t4 * 4);
    }
}

// Store an accumulator tile (rows r0, r0 + 8 of the lane) times ``mul`` as bf16; rows >= S skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, size_t rs, const float (&acc)[32], int r0, int S,
                                           int t4, float mul) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = i * 8 + t4 * 2;
    if (r0 < S) *reinterpret_cast<uint32_t*>(base + r0 * rs + c) = pack_bf16(acc[4 * i] * mul, acc[4 * i + 1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(base + (r0 + 8) * rs + c) =
          pack_bf16(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
  }
}

// x = a X^T and y = b Y^T for 64 columns (a, b: the warpgroup's 64 rows as A
// fragments; X, Y: 64-row K-major B tiles at descriptors dx, dy), one wgmma group.
__device__ __forceinline__ void issue_pair(float (&x)[32], float (&y)[32], const uint32_t (&a)[16],
                                           const uint32_t (&b)[16], uint64_t dx, uint64_t dy) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(x, &a[4 * kk], dx + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(y, &b[4 * kk], dy + 2 * kk, kk);
  wgmma_commit();
}

// dV += P^T dO and dK += dS^T Q for one q tile (B MN-major: 16 q rows = 2048 bytes a k-step), one wgmma group.
__device__ __forceinline__ void issue_dkv(float (&dv)[32], float (&dk)[32], uint32_t (&pa)[16], uint32_t (&da)[16],
                                          uint64_t qdesc, uint64_t dodesc) {
  fence_regs(pa);
  fence_regs(da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(dv, &pa[4 * kk], dodesc + 128 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(dk, &da[4 * kk], qdesc + 128 * kk, 1);
  wgmma_commit();
}

// dq += dS K for one 64-row half of a kv tile (K rows MN-major: 16 rows = 2048 bytes a k-step), one wgmma group.
__device__ __forceinline__ void issue_dq(float (&dq)[32], uint32_t (&dsa)[16], uint64_t kdesc) {
  fence_regs(dsa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(dq, &dsa[4 * kk], kdesc + 128 * kk, 1);
  wgmma_commit();
}

// P^T and dS^T of one q tile in place of S^T (s) and dP^T (dp): the lane's kv
// rows are inside the window where in0 / in1; L, D are the tile's 64 q
// columns' lse log2 e and D.
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
attn_bwd_dkv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + kKVBytes;
  uint8_t* Qs = Vs + kKVBytes;  // stage s at s * kQBytes
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
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * kKVBytes);
      tma_load_4d(Ks, &tk, kv_full, 0, h, kv0, bc);
      tma_load_4d(Vs, &tv, kv_full, 0, h, kv0, bc);
      for (int j = 0; j < nq; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kQBytes);
        tma_load_4d(Qs + s * kQBytes, &tq, &full[s], 0, h, j * kBlockQ, bc);
        tma_load_4d(dOs + s * kQBytes, &tdo, &full[s], 0, h, j * kBlockQ, bc);
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

  // Consumer warpgroups: cw owns kv rows kv0 + 64 cw .. + 63; each lane
  // holds rows kr0 = that + 16 warp + g and kr0 + 8 of the wgmma
  // accumulators (columns 8 i + 2 t4 + {0, 1} of n8 block i).
  reg_alloc<232>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const int kr0 = kv0 + cw * 64 + warp * 16 + g;
  const bool in0 = kr0 < S, in1 = kr0 + 8 < S;
  const int row0 = warp * 16 + g;  // the lane's rows within the warpgroup's 64: row0, row0 + 8
  auto qdesc = [&](int st) { return desc_sw128(Qs + st * kQBytes); };
  auto dodesc = [&](int st) { return desc_sw128(dOs + st * kQBytes); };

  float dkacc[32], dvacc[32], sacc[32], dpacc[32];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = sacc[i] = dpacc[i] = 0.f;
  mbar_wait(kv_full, 0);
  uint32_t ka[16], va[16];  // this warpgroup's K and V rows as A fragments, for every q tile
  load_a_frags(ka, Ks + cw * 64 * 128, row0, t4);
  load_a_frags(va, Vs + cw * 64 * 128, row0, t4);

  // Tile 0 alone, then every tile j issues its scores and tile j - 1's dV/dK
  // products together, so the number of wgmma groups in flight is the same at every wait.
  mbar_wait(&full[0], 0);
  issue_pair(sacc, dpacc, ka, va, qdesc(0), dodesc(0));
  wgmma_wait<0>();
  fence_regs(sacc);
  fence_regs(dpacc);
  dkv_probs(sacc, dpacc, Ls, Dl, in0, in1, t4, scale_log2);
  acc_to_a(pa, sacc);
  acc_to_a(da, dpacc);
  for (int j = 1; j < nq; ++j) {
    const int st = j % kStages, prev = (j - 1) % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    issue_pair(sacc, dpacc, ka, va, qdesc(st), dodesc(st));
    issue_dkv(dvacc, dkacc, pa, da, qdesc(prev), dodesc(prev));
    wgmma_wait<1>();  // the scores of tile j are in; dV/dK of tile j - 1 may still run
    fence_regs(sacc);
    fence_regs(dpacc);
    dkv_probs(sacc, dpacc, Ls + st * kBlockQ, Dl + st * kBlockQ, in0, in1, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(&empty[prev]);
    acc_to_a(pa, sacc);
    acc_to_a(da, dpacc);
  }
  issue_dkv(dvacc, dkacc, pa, da, qdesc((nq - 1) % kStages), dodesc((nq - 1) % kStages));
  wgmma_wait<0>();
  fence_regs(dvacc);
  fence_regs(dkacc);

  const size_t rs = (size_t)H * kF;
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  store_rows(dk + base, rs, dkacc, kr0, S, t4, scale);
  store_rows(dv + base, rs, dvacc, kr0, S, t4, 1.f);
}

// dS of one 64-row half of a kv tile in place of dP (dp), from the raw
// scores s: kv columns from ``left`` on lie past S; L0 / L1 and D0 / D1 are
// the lse log2 e and D of the lane's q rows.
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
attn_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
            const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
            const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
            int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + kDqQBytes;
  uint8_t* Ks = dOs + kDqQBytes;  // stage s at s * kKVBytes
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
    reg_dealloc<40>();
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * kDqQBytes);
      tma_load_4d(Qs, &tq, q_full, 0, h, q0, bc);
      tma_load_4d(dOs, &tdo, q_full, 0, h, q0, bc);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&empty[s], ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_4d(Ks + s * kKVBytes, &tk, &full[s], 0, h, j * kBlockKV, bc);
        tma_load_4d(Vs + s * kKVBytes, &tv, &full[s], 0, h, j * kBlockKV, bc);
      }
    }
    return;
  }

  // Consumer warpgroups: cw owns q rows q0 + 64 cw .. + 63; each lane holds
  // rows r0 = that + 16 warp + g and r0 + 8 of the accumulators.
  reg_alloc<232>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const int row0 = warp * 16 + g, r0 = q0 + cw * 64 + row0;
  const float* lse_b = lse + ((size_t)bc * H + h) * S;
  const float* del_b = delta + ((size_t)bc * H + h) * S;
  const float L0 = r0 < S ? lse_b[r0] * kLog2e : INFINITY, L1 = r0 + 8 < S ? lse_b[r0 + 8] * kLog2e : INFINITY;
  const float D0 = r0 < S ? del_b[r0] : 0.f, D1 = r0 + 8 < S ? del_b[r0 + 8] : 0.f;
  // Half u of the kv tiles: rows 64 u .. 64 u + 63, in stage (u / 2) % kDqStages at row 64 (u % 2).
  auto half = [&](const uint8_t* tiles, int u) {
    return desc_sw128(tiles + ((u >> 1) % kDqStages) * kKVBytes + (u & 1) * 64 * 128);
  };

  float dqacc[32], sacc[32], dpacc[32];
  uint32_t dsa[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dqacc[i] = sacc[i] = dpacc[i] = 0.f;
  mbar_wait(q_full, 0);
  uint32_t qa[16], doa[16];  // this warpgroup's Q and dO rows as A fragments, for every kv tile
  load_a_frags(qa, Qs + cw * 64 * 128, row0, t4);
  load_a_frags(doa, dOs + cw * 64 * 128, row0, t4);

  // Half 0 alone, then every half u issues its scores and half u - 1's dq
  // product together, so the number of wgmma groups in flight is the same at every wait.
  const int halves = 2 * n_tiles;
  mbar_wait(&full[0], 0);
  issue_pair(sacc, dpacc, qa, doa, half(Ks, 0), half(Vs, 0));
  wgmma_wait<0>();
  fence_regs(sacc);
  fence_regs(dpacc);
  dq_probs(sacc, dpacc, S, L0, L1, D0, D1, t4, scale_log2);
  acc_to_a(dsa, dpacc);
  for (int u = 1; u < halves; ++u) {
    if ((u & 1) == 0) mbar_wait(&full[(u >> 1) % kDqStages], ((u >> 1) / kDqStages) & 1);
    issue_pair(sacc, dpacc, qa, doa, half(Ks, u), half(Vs, u));
    issue_dq(dqacc, dsa, half(Ks, u - 1));
    wgmma_wait<1>();  // the scores of half u are in; dq of half u - 1 may still run
    fence_regs(sacc);
    fence_regs(dpacc);
    dq_probs(sacc, dpacc, S - u * 64, L0, L1, D0, D1, t4, scale_log2);
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(dsa);
    if ((u & 1) == 0 && lane == 0) mbar_arrive(&empty[((u >> 1) - 1) % kDqStages]);  // both halves of tile u/2 - 1 done
    acc_to_a(dsa, dpacc);
  }
  issue_dq(dqacc, dsa, half(Ks, halves - 1));
  wgmma_wait<0>();
  fence_regs(dqacc);

  const size_t rs = (size_t)H * kF;
  store_rows(dq + (size_t)bc * S * rs + (size_t)h * kF, rs, dqacc, r0, S, t4, scale);
}

}  // namespace

extern "C" int attention_backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk, void* dv, void* delta, int BC, int S, int H,
                                  float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tdo, tk, tv, tq_dq, tdo_dq;
  int err = encode_rows_map(&tq, q, BC, S, H, kBlockQ);
  if (err == 0) err = encode_rows_map(&tdo, dout, BC, S, H, kBlockQ);
  if (err == 0) err = encode_rows_map(&tk, k, BC, S, H, kBlockKV);
  if (err == 0) err = encode_rows_map(&tv, v, BC, S, H, kBlockKV);
  if (err == 0) err = encode_rows_map(&tq_dq, q, BC, S, H, kDqBlockQ);
  if (err == 0) err = encode_rows_map(&tdo_dq, dout, BC, S, H, kDqBlockQ);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(attn_bwd_dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(attn_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  auto* delta_ = static_cast<float*>(delta);
  const auto* lse_ = static_cast<const float*>(lse);
  const long long rows = (long long)BC * S * H;
  attn_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                                              static_cast<const __nv_bfloat16*>(dout), delta_, S, H,
                                                              rows);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  attn_bwd_dkv<<<dim3((S + kBlockKV - 1) / kBlockKV, H, BC), kThreads, kSmemBytes, st>>>(
      tq, tdo, tk, tv, lse_, delta_, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, scale);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  attn_bwd_dq<<<dim3((S + kDqBlockQ - 1) / kDqBlockQ, H, BC), kThreads, kDqSmemBytes, st>>>(
      tq_dq, tdo_dq, tk, tv, lse_, delta_, static_cast<__nv_bfloat16*>(dq), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return hopper::error_string(err); }
