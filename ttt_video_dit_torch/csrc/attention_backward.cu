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
// exponentials and the float32 dq additions come next.
//
// Design: three launches in the one C entry, all on the caller's stream.
//   1. attn_bwd_delta: D per row, one warp per (token, head).
//   2. attn_bwd_kernel, warp-specialised on TMA, mbarriers and wgmma
//      (hopper.cuh), doing the 5 products in one pass. One block of three
//      warpgroups per (window-batch, head, 128-row kv tile):
//      - producer warpgroup (setmaxnreg down to 40). Warp 0, one thread:
//        the block's K and V tiles (128 x 64 each) once, then for every
//        64-row q tile the Q and dO tiles into a ring of 2 stages by TMA (4-D
//        tensor maps, 128-byte swizzle, zeros past S). Warp 1: the tile's lse
//        (times log2 e; +inf past S) and D (0 past S) beside them. A stage's
//        "full" mbarrier waits for the TMA bytes and warp 1's 32 arrivals, its
//        "empty" one for every consumer warp. Warps 2-3, the dq adders: per q
//        tile they sum the two consumer warpgroups' staged float32 shares of
//        dq into one linear 64 x 64 tile and add it into the float32
//        accumulator with one bulk reduce-add (cp.reduce.async.bulk, .add.f32:
//        the L2 does the adds), double-buffered by tile parity.
//      - two consumer warpgroups (setmaxnreg up to 232), 64 kv rows each. Per
//        q tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (the
//        warpgroup's K and V rows as bf16 A fragments in registers, read once
//        from the swizzled tiles; Q, dO as K-major B in shared memory: an
//        m64n64 product with both operands in shared memory reads 4 KB in
//        its 32 clocks, all of the SM's shared-memory rate);
//        P^T = exp2(S^T scale log2 e - lse log2 e) and
//        dS^T = P^T (dP^T - D) in fp32 registers; dV += P^T dO and
//        dK += dS^T Q by wgmma with P^T and dS^T as bf16 A fragments in
//        registers and dO, Q as MN-major B; dS^T is also stored (bf16,
//        128-byte swizzled) to shared memory, and dS K_rows (A = dS^T read
//        transposed, B = the warpgroup's 64 K rows, MN-major) is its share of
//        the q tile's dq, staged (swizzled float32) for the adders.
//      Blocks start their q loop at different tiles, so concurrent blocks add
//      into different rows. Shared memory: K, V 32 KB + 2 stages x 16.5 KB
//      (Q, dO, lse, D) + dS^T 2 x 8 KB + dq shares 2 x 2 x 16 KB + summed
//      tiles 2 x 16 KB, about 178 KB, dynamic. Registers per consumer thread:
//      dK, dV, dq 32 each, S^T, dP^T 32 each, K, V, P^T, dS^T 16 each as bf16.
//   3. attn_bwd_dq: dq = bf16(accumulator * scale), back to [BC, S, H, 64].
// The accumulator is head-major, [BC, H, S, 64] float32, so that a q tile's
// rows are one contiguous 16 KB bulk add (one 256-byte add per row into a
// token-major accumulator was slower, and adds from the consumers' registers
// by red.global slower still). The float32 adds land in an order that varies from run to
// run, so dq may differ between two runs on the same inputs in its last
// bits; dk and dv are sums in a fixed order and do not. P (for dV) and dS
// (for dK, dQ) are rounded to bf16 as operands, as the forward rounds P; D,
// lse and every sum stay fp32. KV rows >= S get P = 0 and q rows >= S get
// P = 0 (lse = +inf), so the ragged edge needs no padding. The caller
// zeroes the accumulator.
//
// Layouts: q/k/v/o/do/dq/dk/dv [BC, S, H, 64] bf16; lse, delta [BC, H, S]
// f32; the dq accumulator [BC, H, S, 64] f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kF = 64;
constexpr int kBlockKV = 128;  // kv rows per block: two consumer warpgroups x 64
constexpr int kBlockQ = 64;    // q rows per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr int kKVBytes = kBlockKV * kF * 2;  // the K (or V) tile
constexpr int kQBytes = kBlockQ * kF * 2;    // one Q (or dO) stage
constexpr int kDSBytes = 64 * kBlockQ * 2;   // one warpgroup's dS^T
constexpr int kDQBytes = kBlockQ * kF * 4;   // one warpgroup's float32 share of a q tile's dq
constexpr int kSmemBytes = 1024 + 2 * kKVBytes + 2 * kStages * kQBytes + 2 * kDSBytes + 6 * kDQBytes +
                           kStages * 2 * kBlockQ * 4 + 8 * (1 + 2 * kStages + 4);
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

// Add ``bytes`` of float32 at shared ``src`` into global ``dst`` (the L2 does the adds), as one bulk group.
__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most ``kPending`` of this thread's bulk groups still read shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// Byte offset of float column c of row r in a dq staging tile: rows of 256
// bytes, 16-byte chunk k of row r at chunk k ^ (r % 8), so that both the
// accumulator-layout float2 stores and the row-wise float4 loads are free of
// bank conflicts.
__device__ __forceinline__ int dq_offset(int r, int c) {
  return r * 256 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
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

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc, int S, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + kKVBytes;
  uint8_t* Qs = Vs + kKVBytes;           // stage s at s * kQBytes
  uint8_t* dOs = Qs + kStages * kQBytes;
  uint8_t* dSs = dOs + kStages * kQBytes;  // consumer warpgroup c at c * kDSBytes
  uint8_t* dQs = dSs + 2 * kDSBytes;       // [buffer b][consumer warpgroup c] at (2 b + c) * kDQBytes
  uint8_t* dQsum = dQs + 4 * kDQBytes;     // [buffer b] at b * kDQBytes: the summed tile, rows of 256 bytes
  float* Ls = reinterpret_cast<float*>(dQsum + 2 * kDQBytes);  // [stage][64] lse * log2 e
  float* Dl = Ls + kStages * kBlockQ;                         // [stage][64] D
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Dl + kStages * kBlockQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* dq_full = empty + kStages;  // [b]: both warpgroups' dq shares are staged
  uint64_t* dq_empty = dq_full + 2;     // [b]: the adder warps have read them

  const int tid = threadIdx.x;
  const int h = blockIdx.y, bc = blockIdx.z, kv0 = blockIdx.x * kBlockKV;
  const int nq = (S + kBlockQ - 1) / kBlockQ;
  const int j0 = (2 * blockIdx.x) % nq;  // this block's first q tile

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
    for (int b = 0; b < 2; ++b) {
      mbar_init(&dq_full[b], 256);
      mbar_init(&dq_empty[b], 64);
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
        const int s = j % kStages, qt = j0 + j < nq ? j0 + j : j0 + j - nq;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kQBytes);
        tma_load_4d(Qs + s * kQBytes, &tq, &full[s], 0, h, qt * kBlockQ, bc);
        tma_load_4d(dOs + s * kQBytes, &tdo, &full[s], 0, h, qt * kBlockQ, bc);
      }
    } else if (tid >= 32 && tid < 64) {
      const int lane = tid - 32;
      const float* lse_b = lse + ((size_t)bc * H + h) * S;
      const float* del_b = delta + ((size_t)bc * H + h) * S;
      for (int j = 0; j < nq; ++j) {
        const int s = j % kStages, qt = j0 + j < nq ? j0 + j : j0 + j - nq;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        for (int r = lane; r < kBlockQ; r += 32) {
          const int q = qt * kBlockQ + r;
          Ls[s * kBlockQ + r] = q < S ? lse_b[q] * kLog2e : INFINITY;
          Dl[s * kBlockQ + r] = q < S ? del_b[q] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    } else if (tid >= 64) {  // warps 2 and 3: add the two warpgroups' dq shares into the accumulator
      const int ft = tid - 64;
      for (int j = 0; j < nq; ++j) {
        const int b = j & 1, qt = j0 + j < nq ? j0 + j : j0 + j - nq;
        mbar_wait(&dq_full[b], (j >> 1) & 1);
        bulk_wait_read<1>();  // thread 0's bulk add of tile j - 2 has read dQsum[b]
        named_sync(3, 64);
        const uint8_t* s0 = dQs + 2 * b * kDQBytes;
        uint8_t* sum = dQsum + b * kDQBytes;
#pragma unroll 4
        for (int f = ft; f < kBlockQ * kF / 4; f += 64) {
          const int r = f >> 4, off = dq_offset(r, (f & 15) * 4);
          const float4 x = *reinterpret_cast<const float4*>(s0 + off);
          const float4 y = *reinterpret_cast<const float4*>(s0 + kDQBytes + off);
          *reinterpret_cast<float4*>(sum + f * 16) = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
        }
        mbar_arrive(&dq_empty[b]);
        fence_proxy_async();
        named_sync(3, 64);
        if (ft == 0)  // the tile's rows inside the window, contiguous in the [BC, H, S, 64] accumulator
          bulk_reduce_add(dq_acc + (((size_t)bc * H + h) * S + qt * kBlockQ) * kF, sum,
                          min(kBlockQ, S - qt * kBlockQ) * kF * 4);
      }
      bulk_wait_read<0>();
    }
    return;
  }

  // Consumer warpgroups: cw owns kv rows kv0 + 64 cw .. + 63; each lane
  // holds rows kr0 = that + 16 warp + g and kr0 + 8 of the wgmma
  // accumulators (columns 8 i + 2 t4 + {0, 1} of n8 block i).
  reg_alloc<232>();
  const int cw = tid / 128 - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31, g = lane >> 2, t4 = lane & 3;
  const uint64_t kdesc = desc_sw128(Ks + cw * 64 * 128);
  uint8_t* dS = dSs + cw * kDSBytes;
  const uint64_t dsdesc = desc_sw128(dS);
  const float scale_log2 = scale * kLog2e;
  const int kr0 = kv0 + cw * 64 + warp * 16 + g;
  const bool in0 = kr0 < S, in1 = kr0 + 8 < S;
  const int row0 = warp * 16 + g;  // the lane's rows within the warpgroup's dS^T tile: row0, row0 + 8

  float dkacc[32], dvacc[32], sacc[32], dpacc[32], dqacc[32];
  uint32_t pa[16], da[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = sacc[i] = dpacc[i] = dqacc[i] = 0.f;
  mbar_wait(kv_full, 0);
  uint32_t ka[16], va[16];  // this warpgroup's K and V rows as A fragments, for every q tile
  load_a_frags(ka, Ks + cw * 64 * 128, row0, t4);
  load_a_frags(va, Vs + cw * 64 * 128, row0, t4);

  for (int j = 0; j < nq; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    const uint64_t qdesc = desc_sw128(Qs + st * kQBytes), dodesc = desc_sw128(dOs + st * kQBytes);

    // S^T = K Q^T, dP^T = V dO^T (64 kv rows x 64 q columns each).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(sacc, &ka[4 * kk], qdesc + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<0>(dpacc, &va[4 * kk], dodesc + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(dpacc);

    const float* L = Ls + st * kBlockQ;
    const float* Dd = Dl + st * kBlockQ;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = i * 8 + t4 * 2 + (e & 1);
        const float p = (e < 2 ? in0 : in1) ? exp2_ftz(fmaf(sacc[4 * i + e], scale_log2, -L[col])) : 0.f;
        dpacc[4 * i + e] = p * (dpacc[4 * i + e] - Dd[col]);  // dS^T
        sacc[4 * i + e] = p;                                  // P^T
      }
    acc_to_a(pa, sacc);
    acc_to_a(da, dpacc);
    // dS^T to shared memory, 128-byte swizzled: row r's 16-byte chunk i at chunk i ^ (r % 8).
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      *reinterpret_cast<uint32_t*>(dS + row0 * 128 + ((i ^ g) << 4) + t4 * 4) = da[2 * i];
      *reinterpret_cast<uint32_t*>(dS + (row0 + 8) * 128 + ((i ^ g) << 4) + t4 * 4) = da[2 * i + 1];
    }

    // dV += P^T dO, dK += dS^T Q (B MN-major: 16 q rows = 2048 bytes a k-step).
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(dvacc, &pa[4 * kk], dodesc + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(dkacc, &da[4 * kk], qdesc + 128 * kk, 1);
    wgmma_commit();

    // This warpgroup's share of dq: dS (64 q x 64 kv, dS^T read transposed) times its 64 K rows.
    fence_proxy_async();
    named_sync(1 + cw, 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<1, 1>(dqacc, dsdesc + 128 * kk, kdesc + 128 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(dqacc);
    fence_regs(pa);
    fence_regs(da);
    if (lane == 0) mbar_arrive(&empty[st]);

    // Stage this warpgroup's share for the adder warps (double-buffered by tile parity).
    const int b = j & 1;
    mbar_wait(&dq_empty[b], ((j >> 1) & 1) ^ 1);
    uint8_t* stg = dQs + (2 * b + cw) * kDQBytes;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = i * 8 + t4 * 2;
      *reinterpret_cast<float2*>(stg + dq_offset(row0, c)) = make_float2(dqacc[4 * i], dqacc[4 * i + 1]);
      *reinterpret_cast<float2*>(stg + dq_offset(row0 + 8, c)) = make_float2(dqacc[4 * i + 2], dqacc[4 * i + 3]);
    }
    mbar_arrive(&dq_full[b]);
  }

  const size_t rs = (size_t)H * kF;
  const size_t base = (size_t)bc * S * rs + (size_t)h * kF;
  store_rows(dk + base, rs, dkacc, kr0, S, t4, scale);
  store_rows(dv + base, rs, dvacc, kr0, S, t4, 1.f);
}

// dq[bc, s, h, :] = bf16(acc[bc, h, s, :] * scale), four elements a thread.
__global__ void __launch_bounds__(256)
attn_bwd_dq(const float4* __restrict__ acc, uint2* __restrict__ dq, float scale, int S, int H, long long n4) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4; i += (long long)gridDim.x * 256) {
    const long long row = i >> 4;  // (bc, s, h) of the output
    const int h = (int)(row % H);
    const long long bs = row / H, bc = bs / S, s = bs % S;
    const float4 a = acc[(((bc * H + h) * S + s) << 4) + (i & 15)];
    dq[i] = make_uint2(pack_bf16(a.x * scale, a.y * scale), pack_bf16(a.z * scale, a.w * scale));
  }
}

}  // namespace

extern "C" int attention_backward(const void* q, const void* k, const void* v, const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk, void* dv, void* delta, void* dq_acc, int BC,
                                  int S, int H, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tdo, tk, tv;
  int err = encode_rows_map(&tq, q, BC, S, H, kBlockQ);
  if (err == 0) err = encode_rows_map(&tdo, dout, BC, S, H, kBlockQ);
  if (err == 0) err = encode_rows_map(&tk, k, BC, S, H, kBlockKV);
  if (err == 0) err = encode_rows_map(&tv, v, BC, S, H, kBlockKV);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(attn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);

  auto* delta_ = static_cast<float*>(delta);
  const long long rows = (long long)BC * S * H;
  attn_bwd_delta<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(o),
                                                              static_cast<const __nv_bfloat16*>(dout), delta_, S, H,
                                                              rows);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((S + kBlockKV - 1) / kBlockKV, H, BC);
  attn_bwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(tq, tdo, tk, tv, static_cast<const float*>(lse), delta_,
                                                      static_cast<__nv_bfloat16*>(dk),
                                                      static_cast<__nv_bfloat16*>(dv), static_cast<float*>(dq_acc), S,
                                                      H, scale);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const long long n4 = rows * kF / 4;
  const unsigned blocks = (unsigned)(n4 < 132LL * 64 * 256 ? (n4 + 255) / 256 : 132LL * 64);
  attn_bwd_dq<<<blocks, 256, 0, st>>>(static_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), scale, S, H, n4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) { return hopper::error_string(err); }
