// Fused TTT-linear backward (K6@F128), head_dim F = 128, mini-batch CS = 16,
// bf16 q/k/v, for Hopper (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_linear_bwd_kernel
// (launched by ttt_linear_backward, l.594, and reduced by
// ttt_vjp.py:_linear_bwd_pre) at head dim 128 (d3072 at 24 heads), which the
// JAX package takes at any F % 8 == 0. It computes what
// ttt_linear_backward.cu computes at F = 64: the VJP of the training forward
// scan (ttt_linear_forward_f128.cu with K > 0) from that kernel's fp32 state
// checkpoints. Per (batch, head) it walks the checkpoint groups last to first
// (the ragged group first); per group, pass A re-runs the forward from the
// group's checkpoint and stashes each step's operands, and pass B walks the
// group backwards through the hand-derived step VJP (ttt_backward.py:
// 510-565): the output LN, the dual-form products, the second-order LN term,
// the target LN, rope and L2-norm VJPs and the sigmoid gate,
// d_gate = de * eta * (1 - sigmoid).
//
// What bounds it on the H100: as in the forward, the scan is sequential, so
// one block owns one (batch, head) and the limit is the latency of one step
// inside an SM: pass A's forward step, then pass B's ten small products and
// three row passes, each waiting on the one before. Device memory is not the
// limit. At B = 1 and 24 heads the grid is 24 blocks on 132 SMs.
//
// Design: ttt_linear_backward.cu's two passes on ttt_linear_f128.cuh's step.
// One block of 12 warps per (batch, head); every product runs on the tensor
// cores (mma.sync m16n8k16, operands rounded to bf16 where the Pallas kernel
// calls .astype(dt): XQ, XK, W, Gs, A1, dZb1, dA1, the carry dW, dZ1; fp32
// accumulation).
// - Pass A is the header's step without the output: warps 0-7 keep the state
//   W^T in registers (64 a thread), warps 8-11 prepare the next mini-batch.
//   Each step writes what pass B needs to an L2-resident workspace (63.75 KiB
//   a step at CS 16: bf16(W^T) before the step 34 KiB, XQ, XK, Gs 12.75 KiB,
//   -A1 0.5 KiB, Z1 and Z1_bar in fp32 16.5 KiB; ~6 MB at K 4 and 24 heads),
//   as byte images of the tiles.
// - The carry dW^T (128 x 128 fp32) lives in shared memory, 64 KiB, in the
//   state's accumulator layout, fragment-major (each (warp, k-tile, lane) one
//   16-byte vector, so a warp's loads and stores touch every bank once).
//   Registers cannot hold it beside the state in pass A (64 + 64 of the 168
//   a thread that 12 warps leave) nor beside the row passes' values in pass
//   B, so warps 0-7 load their 16 rows of it into mma accumulators for each
//   of the two updates a step and store them back. Its bf16 copy (the dG and
//   dXK products' operand) is a padded [128][136] tile beside it.
// - Pass B thus recomputes no forward product. Its 12 warps take a step in
//   four phases with one block barrier after each: (P0) the row pass of the
//   preprocessing and the output LN's VJP (dZb1), warps 0-7; (P5) the
//   products of dZb1: warps 0-7 compute dG = -A1^T dZb1c - db - XK bf16(dW)
//   for their 16 columns and dW^T += dZb1c^T XQ, warps 8-11 compute dXQ =
//   dZb1c W^T + dA1 XK and start dXK = -Gs bf16(dW)^T + dA1^T XQ for their 32
//   (dA1 = bf16(-dZb1c Gs^T) recomputed as A fragments in each of the four,
//   A1^T and dA1^T by movmatrix); (P6) the row pass of the LN-L2 VJP, the
//   target LN's VJP, dXV and d_gate (dZ1), warps 0-7; (P7) dW^T += dZ1c^T XK
//   and db in warps 0-7 (which then write bf16(dW^T) for the next step),
//   dXK += dZ1c W^T in warps 8-11; then the rope and L2-norm VJPs of dXQ and
//   dXK (P8), warps 0-7. The next step's raw rows and stash are fetched by
//   cp.async after P8 into the one buffer that fits (F = 64's kBufB = 1).
// - Row passes: warp w of 0-7 takes rows 16 s + 2 w and 16 s + 2 w + 1 of
//   every slab s, 16 lanes a row, 8 features a lane; what a row's P0 computes
//   for P6 and P8 (the target, t_hat, its std, eta, the gate's sigmoid, dXV)
//   stays in registers.
// - Shared memory at CS 16: pass A's ring and tiles and pass B's buffers are
//   one union (the two passes never overlap; pass B's 125 KiB the larger),
//   beside the carry (64 KiB) and its bf16 copy (34 KiB): ~223 KiB of the
//   227 a block may have. The LN-parameter cotangents are summed per lane
//   over its rows and the whole scan and reduced across the warps once at
//   the end; the LN and bias gradients come out compact ([F]) per (batch,
//   head), and the wrapper sums them over the batch.
//
// Layouts: as ttt_linear_forward_f128.cu; dout/dxq/dxk/dxv [B, NC, CS, H*128]
// bf16; dgate [B, H, NC, CS] f32; checkpoints W1 [B, H, NG, 128, 128], b1
// [B, H, NG, 1, 128] f32; outputs dW1 [B, H, 128, 128], db1 [B, H, 1, 128],
// dln_w/dln_b [B, H, 128] f32; workspaces [B, H, K] of StashH and of StashF.
// Every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_linear_f128.cuh"
#include "ttt_linear_step.cuh"  // negate, transpose_a (fragment helpers, the same at any head dim)

namespace {

using namespace tttl128;
using tttl::negate;
using tttl::transpose_a;

template <int NS>
struct RawStageB : RawStage<NS> {  // pass B: the output cotangent rows too
  bf16 dout[kSlab * NS * kF];
};

template <int NS>
struct PassA {
  static constexpr int kCS = kSlab * NS;
  RawStage<NS> raw[2];    // the producer's ring
  PrepStage<NS> prep[2];  // the prepared ring
  float z[kCS * kLdZ];    // Z1
  bf16 gs[kCS * kLdB];    // Gs
};

template <int NS>
struct PassB {
  static constexpr int kCS = kSlab * NS;
  RawStageB<NS> raw;  // the step's raw rows (+ dout)
  StashH<NS> sh;      // ... and its stash
  StashF<NS> sf;
  float dzb[kCS * kLdZ];  // dZb1 (P0 -> P5), then dZ1 (P6 -> P7)
  float dg[kCS * kLdZ];   // dG (P5 -> P6), then dXK (P7 -> P8)
  float dxq[kCS * kLdZ];  // dXQ (P5 -> P8)
  bf16 dzbc[kCS * kLdB];  // bf16(dZb1), then bf16(dZ1)
};

constexpr int kCarryFloats = kF * kF;  // dW^T, fragment-major: [warp][k-tile f][lane][4]

template <int NS>
struct Smem {
  union {
    PassA<NS> a;
    PassB<NS> b;
  } u;
  float carry[kCarryFloats];
  bf16 dwt[kF * kLdB];  // bf16(dW^T) of the carry, [c][k]
  uint64_t full[2], empty[2];
};
static_assert(sizeof(RawStageB<1>) % 16 == 0 && sizeof(Smem<1>) <= 232448, "exceeds the 227 KB shared-memory opt-in");

struct BwdArgs {
  ScanArgs a;
  const float *ln_w, *ln_b, *w_ck, *b_ck;
  const bf16* dout;
  bf16 *dxq, *dxk, *dxv;
  float *dgate, *dW, *db, *dlnw, *dlnb;
  void* sh;  // StashH<NS> [B, H, K]
  void* sf;  // StashF<NS> [B, H, K]
  int K;
};

// The carry's 16 rows of warp ``warp`` in LinState's layout, from and to shared memory.
__device__ __forceinline__ void load_carry(float (&w)[kF / 8][4], const float* carry, int warp, int lane) {
#pragma unroll
  for (int f = 0; f < kF / 8; ++f) {
    const float4 v = reinterpret_cast<const float4*>(carry)[(warp * (kF / 8) + f) * 32 + lane];
    w[f][0] = v.x;
    w[f][1] = v.y;
    w[f][2] = v.z;
    w[f][3] = v.w;
  }
}

__device__ __forceinline__ void store_carry(float* carry, const float (&w)[kF / 8][4], int warp, int lane) {
#pragma unroll
  for (int f = 0; f < kF / 8; ++f)
    reinterpret_cast<float4*>(carry)[(warp * (kF / 8) + f) * 32 + lane] = make_float4(w[f][0], w[f][1], w[f][2], w[f][3]);
}

// The sum over the CS = 16 NS rows of columns c0 + 8 u + 2t, + 1 of an fp32 tile, in every lane.
template <int NS>
__device__ __forceinline__ float2 column_sum(const float* src, int c0, int u, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float x = 0.f, y = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(src + (kSlab * j + g) * kLdZ + c0 + 8 * u + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(src + (kSlab * j + g + 8) * kLdZ + c0 + 8 * u + 2 * t);
    x += a.x + b.x;
    y += a.y + b.y;
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
    y += __shfl_xor_sync(0xffffffffu, y, off);
  }
  return make_float2(x, y);
}

template <int CS>
__global__ void __launch_bounds__(kThreads, 1) ttt_linear_bwd_f128_kernel(const BwdArgs A) {
  constexpr int NS = CS / kSlab, kCS = kSlab * NS;
  static_assert(CS % kSlab == 0, "whole 16-token slabs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NS>& S = *reinterpret_cast<Smem<NS>*>(smem_raw);
  PassB<NS>& P = S.u.b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC, K = A.K;
  const int NG = (NC + K - 1) / K;
  const bool cwarp = warp < kWarps;  // warps 0-7: the state in pass A, the carry dW^T and the row passes in pass B
  const size_t HF = (size_t)A.a.H * kF;
  StashH<NS>* SH = static_cast<StashH<NS>*>(A.sh) + (size_t)bh * K;
  StashF<NS>* SF = static_cast<StashF<NS>*>(A.sf) + (size_t)bh * K;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&S.full[s], kProducers);
      hopper::mbar_init(&S.empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < kF * kLdB / 2; i += kThreads) reinterpret_cast<uint32_t*>(S.dwt)[i] = 0u;
  for (int i = tid; i < kCarryFloats / 4; i += kThreads) reinterpret_cast<float4*>(S.carry)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int r0 = 2 * warp + lane / kRowLanes, f = 8 * (lane % kRowLanes);  // pass B's rows r0 + 16 s (warps 0-7)
  float lw[8], lb[8];
  ld_f32(lw, A.ln_w + (size_t)h * kF + f);
  ld_f32(lb, A.ln_b + (size_t)h * kF + f);
  float2 db[2] = {}, dbt[2] = {};    // warps 0-7: db, db_tot of the warp's columns
  float accw[8] = {}, accb[8] = {};  // dln_w / dln_b over this lane's rows

  // cp.async step j's raw rows (with dout) and stash into pass B's buffer; every thread, then one commit.
  auto fetch = [&](int n0, int j) {
    RawStageB<NS>& R = P.raw;
    const int n = n0 + j;
    const size_t x0 = ((size_t)b * NC + n) * CS * HF + (size_t)h * kF;
    for (int i = tid; i < CS * (kF / 8); i += kThreads) {
      const int row = i / (kF / 8), c = (i % (kF / 8)) * 8;
      const size_t go = x0 + row * HF + c;
      const int so = row * kF + c;
      hopper::cp_async16(R.q + so, A.a.xq + go);
      hopper::cp_async16(R.k + so, A.a.xk + go);
      hopper::cp_async16(R.v + so, A.a.xv + go);
      hopper::cp_async16(R.dout + so, A.dout + go);
    }
    const size_t t0 = (size_t)n * CS * kF;
    for (int i = tid; i < CS * kF / 4; i += kThreads) {
      hopper::cp_async16(R.cos + 4 * i, A.a.cos + t0 + 4 * i);
      hopper::cp_async16(R.sin + 4 * i, A.a.sin + t0 + 4 * i);
    }
    const size_t g0 = (((size_t)b * A.a.H + h) * NC + n) * CS;
    for (int i = tid; i < CS / 4; i += kThreads) hopper::cp_async16(R.gate + 4 * i, A.a.gate + g0 + 4 * i);
    const uint4* srch = reinterpret_cast<const uint4*>(SH + j);
    uint4* dsth = reinterpret_cast<uint4*>(&P.sh);
    for (int i = tid; i < (int)(sizeof(StashH<NS>) / 16); i += kThreads) hopper::cp_async16(dsth + i, srch + i);
    const uint4* srcf = reinterpret_cast<const uint4*>(SF + j);
    uint4* dstf = reinterpret_cast<uint4*>(&P.sf);
    for (int i = tid; i < (int)(sizeof(StashF<NS>) / 16); i += kThreads) hopper::cp_async16(dstf + i, srcf + i);
    hopper::cp_async_commit();
  };

  int it = 0;  // mini-batches the pass-A ring has carried
  for (int gi = NG - 1; gi >= 0; --gi) {
    const int n0 = gi * K, valid = min(K, NC - n0);
    __syncthreads();  // the previous pass B is done with the buffers

    // ---------------- Pass A: the forward from checkpoint gi, stashing each step.
    if (!cwarp) {
      producer<CS, true>(S.u.a.raw, S.u.a.prep, S.full, S.empty, A.a, A.ln_w, A.ln_b, b, h, n0, valid, it,
                         warp - kWarps, lane, SH);
    } else {
      LinState st;
      const size_t ck = (size_t)bh * NG + gi;
      load_state(st, A.w_ck + ck * kF * kF, A.b_ck + ck * kF, warp, lane);
      for (int i = 0; i < valid; ++i) {
        const int s = (it + i) & 1;
        hopper::mbar_wait(&S.full[s], ((it + i) >> 1) & 1);
        step<CS, false, true>(st, S.u.a.prep[s], S.u.a, lw, lb, nullptr, 0, SH + i, SF + i, warp, lane);
        hopper::mbar_arrive(&S.empty[s]);
      }
    }
    it += valid;
    __threadfence_block();
    __syncthreads();  // the stash is written; pass A's ring and tiles are free for pass B's buffers
    fetch(n0, valid - 1);
    hopper::cp_async_wait<0>();
    __syncthreads();

    // ---------------- Pass B: the step VJP, last step first.
    for (int j = valid - 1; j >= 0; --j) {
      const int n = n0 + j;
      const RawStageB<NS>& R = P.raw;
      const StashH<NS>& SHj = P.sh;
      const StashF<NS>& SFj = P.sf;
      const size_t xo = ((size_t)b * NC + n) * CS * HF + (size_t)h * kF + r0 * HF + f;

      // P0: preprocessing of rows r0 + 16 s, kept for the VJPs (target, t_hat, its std, eta); out = XQ + LN(Zb1):
      // dZb1 and the LN-affine cotangents.
      float tgt[NS][8], that[NS][8], sdt[NS], eta[NS], sig[NS];
      if (cwarp) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = r0 + kSlab * s;
          float k[8], v[8], c[8], sn[8], xk[8], tt[8];
          ld_bf16(k, R.k + r * kF + f);
          ld_bf16(v, R.v + r * kF + f);
          ld_f32(c, R.cos + r * kF + f);
          ld_f32(sn, R.sin + r * kF + f);
          l2norm_rope(xk, k, c, sn);
#pragma unroll
          for (int i = 0; i < 8; ++i) tt[i] = v[i] - xk[i];
          sdt[s] = target_ln(that[s], tt);
#pragma unroll
          for (int i = 0; i < 8; ++i) tgt[s][i] = lw[i] * that[s][i] + lb[i];
          sig[s] = 1.f / (1.f + expf(-R.gate[r]));
          eta[s] = sig[s] * A.a.eta_scale;

          float zb[8], xh[8], dO[8], wv[8], dz[8];
          ld_f32(zb, SFj.zb1 + r * kLdZ + f);
          ld_bf16(dO, R.dout + r * kF + f);
          const float sd = ln_stats(xh, zb);
          float mw = 0.f, mwx = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            wv[i] = lw[i] * dO[i];
            mw += wv[i];
            mwx += wv[i] * xh[i];
          }
          mw = group_sum<kRowLanes>(mw) * (1.f / kF);
          mwx = group_sum<kRowLanes>(mwx) * (1.f / kF);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dz[i] = (wv[i] - mw - xh[i] * mwx) / sd;
            accw[i] += dO[i] * xh[i];
            accb[i] += dO[i];
          }
          st_f32(P.dzb + r * kLdZ + f, dz);
          st_bf16(P.dzbc + r * kLdB + f, dz);
        }
      }
      __syncthreads();  // (A) dZb1

      // P5: the products of dZb1c.
      float xk[NS][2][2][4] = {};  // warps 8-11: dXK of their 32 columns (two 16-column blocks), every slab, until P7
      if (cwarp) {
        const int c0 = 16 * warp;
        uint32_t bz[NS][4];
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) ldb_kn(bz[jj], P.dzbc, kSlab * jj, c0, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 cs = column_sum<NS>(P.dzb, c0, u, lane);
          dbt[u] = make_float2(db[u].x + cs.x, db[u].y + cs.y);
        }
        // dG = -A1^T dZb1c - XK bf16(dW) - db_tot, slab s of the tokens
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float dg[2][4] = {};
#pragma unroll
          for (int jj = 0; jj < NS; ++jj) {
            uint32_t na[4], at[4];
            ld_frag(na, SHj.neg_attn, NS * jj + s, lane);
            transpose_a(at, na);  // block (s, jj) of -A1^T
            mma_bf16_16816(dg[0], at, bz[jj][0], bz[jj][1]);
            mma_bf16_16816(dg[1], at, bz[jj][2], bz[jj][3]);
          }
#pragma unroll
          for (int kk = 0; kk < kF / 16; ++kk) {
            uint32_t ak[4], wb[4];
            lda(ak, SHj.xk, kSlab * s, 16 * kk, lane);
            negate(ak);
            ldb_nk(wb, S.dwt, c0, 16 * kk, lane);  // bf16(dW)[k][c] from the [c][k] copy
            mma_bf16_16816(dg[0], ak, wb[0], wb[1]);
            mma_bf16_16816(dg[1], ak, wb[2], wb[3]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dg[u][e] -= (e & 1) ? dbt[u].y : dbt[u].x;
          store_block(P.dg + kSlab * s * kLdZ, dg, c0, lane);
        }
        // dW^T += dZb1c^T XQ (dG read the carry's bf16 copy, which changes only in P7)
        float dw[kF / 8][4];
        load_carry(dw, S.carry, warp, lane);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          const uint32_t a[4] = {bz[jj][0], bz[jj][2], bz[jj][1], bz[jj][3]};
          update_rows(dw, a, SHj.xq + kSlab * jj * kLdB, lane);
        }
        store_carry(S.carry, dw, warp, lane);
      } else {
        const int k0 = 32 * (warp - kWarps);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float da[NS][2][4] = {}, xq[2][2][4] = {};
#pragma unroll
          for (int kk = 0; kk < kF / 16; ++kk) {
            uint32_t az[4], ag[4];
            lda(az, P.dzbc, kSlab * s, 16 * kk, lane);
#pragma unroll
            for (int jj = 0; jj < NS; ++jj) {
              uint32_t gb[4];
              ldb_nk(gb, SHj.gs, kSlab * jj, 16 * kk, lane);
              mma_bf16_16816(da[jj][0], az, gb[0], gb[1]);  // dZb1c Gs^T, block (s, jj)
              mma_bf16_16816(da[jj][1], az, gb[2], gb[3]);
            }
            lda(ag, SHj.gs, kSlab * s, 16 * kk, lane);
            negate(ag);
#pragma unroll
            for (int cb = 0; cb < 2; ++cb) {
              uint32_t wb[4], dwb[4];
              ldb_kn(wb, SHj.wt, 16 * kk, k0 + 16 * cb, lane);
              mma_bf16_16816(xq[cb][0], az, wb[0], wb[1]);  // dZb1c W^T
              mma_bf16_16816(xq[cb][1], az, wb[2], wb[3]);
              ldb_kn(dwb, S.dwt, 16 * kk, k0 + 16 * cb, lane);
              mma_bf16_16816(xk[s][cb][0], ag, dwb[0], dwb[1]);  // -Gs bf16(dW)^T
              mma_bf16_16816(xk[s][cb][1], ag, dwb[2], dwb[3]);
            }
          }
          // dA1 = bf16(-dZb1c Gs^T) block by block as A fragments; dXQ += dA1 XK; dXK += dA1^T XQ.
#pragma unroll
          for (int jj = 0; jj < NS; ++jj) {
            const uint32_t dA[4] = {pack_bf16(-da[jj][0][0], -da[jj][0][1]), pack_bf16(-da[jj][0][2], -da[jj][0][3]),
                                    pack_bf16(-da[jj][1][0], -da[jj][1][1]), pack_bf16(-da[jj][1][2], -da[jj][1][3])};
            uint32_t dAt[4];
            transpose_a(dAt, dA);
#pragma unroll
            for (int cb = 0; cb < 2; ++cb) {
              uint32_t xb[4];
              ldb_kn(xb, SHj.xk, kSlab * jj, k0 + 16 * cb, lane);
              mma_bf16_16816(xq[cb][0], dA, xb[0], xb[1]);
              mma_bf16_16816(xq[cb][1], dA, xb[2], xb[3]);
              ldb_kn(xb, SHj.xq, kSlab * s, k0 + 16 * cb, lane);
              mma_bf16_16816(xk[jj][cb][0], dAt, xb[0], xb[1]);
              mma_bf16_16816(xk[jj][cb][1], dAt, xb[2], xb[3]);
            }
          }
#pragma unroll
          for (int cb = 0; cb < 2; ++cb) store_block(P.dxq + kSlab * s * kLdZ, xq[cb], k0 + 16 * cb, lane);
        }
      }
      __syncthreads();  // (B) dG, dXQ

      // P6: Gs = eta g1: de, dg1; g1 = ln_fused_l2(Z1, target): dZ1, dtarget; target = LN(XV - XK): dXV;
      //     d_gate = de * eta * (1 - sigmoid).
      float dv[NS][8];
      if (cwarp) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = r0 + kSlab * s;
          float z1[8], zh[8], gx[8], g1[8], dG[8], u[8], dgx[8], dxh[8], dz[8];
          ld_f32(z1, SFj.z1 + r * kLdZ + f);
          ld_f32(dG, P.dg + r * kLdZ + f);
          const float sd = ln_stats(zh, z1);
          float m1 = 0.f, m2 = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            gx[i] = lw[i] * ((lw[i] * zh[i] + lb[i]) - tgt[s][i]);
            m1 += gx[i];
            m2 += gx[i] * zh[i];
          }
          m1 = group_sum<kRowLanes>(m1) * (1.f / kF);
          m2 = group_sum<kRowLanes>(m2) * (1.f / kF);
          float de = 0.f, mu = 0.f, mux = 0.f, sug = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            g1[i] = (gx[i] - m1 - zh[i] * m2) / sd;
            de += dG[i] * g1[i];
            u[i] = eta[s] * dG[i];
            mu += u[i];
            mux += u[i] * zh[i];
            sug += u[i] * g1[i];
          }
          de = group_sum<kRowLanes>(de);
          mu = group_sum<kRowLanes>(mu) * (1.f / kF);
          mux = group_sum<kRowLanes>(mux) * (1.f / kF);
          const float dstd = -group_sum<kRowLanes>(sug) / sd;
          float mdx = 0.f, mdxx = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dgx[i] = (u[i] - mu - zh[i] * mux) / sd;
            dxh[i] = -(m2 * u[i] + gx[i] * mux) / sd + lw[i] * lw[i] * dgx[i];
            mdx += dxh[i];
            mdxx += dxh[i] * zh[i];
          }
          mdx = group_sum<kRowLanes>(mdx) * (1.f / kF);
          mdxx = group_sum<kRowLanes>(mdxx) * (1.f / kF);
          float gg[8], mg = 0.f, sgt = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dz[i] = (dxh[i] - mdx - zh[i] * mdxx) / sd + dstd * zh[i] / kF;
            const float dt = -lw[i] * dgx[i];
            const float y = lw[i] * zh[i] + lb[i];
            accw[i] += dgx[i] * (y - tgt[s][i]) + dgx[i] * lw[i] * zh[i];
            accb[i] += dgx[i] * lw[i];
            // target = lnw * t_hat + lnb, t_hat = (t - mu) / s, s = sqrt(unbiased var) + eps.
            gg[i] = lw[i] * dt;
            mg += gg[i];
            sgt += gg[i] * that[s][i];
            accw[i] += dt * that[s][i];
            accb[i] += dt;
          }
          mg = group_sum<kRowLanes>(mg) * (1.f / kF);
          sgt = group_sum<kRowLanes>(sgt);
          const float sqrtv = fmaxf(sdt[s] - 1e-8f, 1e-20f);
#pragma unroll
          for (int i = 0; i < 8; ++i) dv[s][i] = (gg[i] - mg) / sdt[s] - that[s][i] * (sgt / ((kF - 1) * sqrtv));
          st_f32(P.dzb + r * kLdZ + f, dz);
          st_bf16(P.dzbc + r * kLdB + f, dz);
          st_bf16(A.dxv + xo + kSlab * s * HF, dv[s]);
          if (lane % kRowLanes == 0)
            A.dgate[(((size_t)b * A.a.H + h) * NC + n) * CS + r] = de * eta[s] * (1.f - sig[s]);
        }
      }
      __syncthreads();  // (C) dZ1

      // P7: dW^T += dZ1c^T XK; db = db_tot + colsum(dZ1); dXK += dZ1c W^T.
      if (cwarp) {
        const int c0 = 16 * warp;
        float dw[kF / 8][4];
        load_carry(dw, S.carry, warp, lane);
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          uint32_t bz[4];
          ldb_kn(bz, P.dzbc, kSlab * jj, c0, lane);
          const uint32_t a[4] = {bz[0], bz[2], bz[1], bz[3]};
          update_rows(dw, a, SHj.xk + kSlab * jj * kLdB, lane);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 cs = column_sum<NS>(P.dzb, c0, u, lane);
          db[u] = make_float2(dbt[u].x + cs.x, dbt[u].y + cs.y);
        }
        store_wt(S.dwt, dw, warp, lane);
        store_carry(S.carry, dw, warp, lane);
      } else {
        const int k0 = 32 * (warp - kWarps);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
          for (int kk = 0; kk < kF / 16; ++kk) {
            uint32_t az[4];
            lda(az, P.dzbc, kSlab * s, 16 * kk, lane);
#pragma unroll
            for (int cb = 0; cb < 2; ++cb) {
              uint32_t wb[4];
              ldb_kn(wb, SHj.wt, 16 * kk, k0 + 16 * cb, lane);
              mma_bf16_16816(xk[s][cb][0], az, wb[0], wb[1]);
              mma_bf16_16816(xk[s][cb][1], az, wb[2], wb[3]);
            }
          }
#pragma unroll
          for (int cb = 0; cb < 2; ++cb) store_block(P.dg + kSlab * s * kLdZ, xk[s][cb], k0 + 16 * cb, lane);  // dXK
        }
      }
      __syncthreads();  // (D) dXK, bf16(dW^T)

      // P8: rope and L2-norm VJPs back to the raw projections.
      if (cwarp) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const int r = r0 + kSlab * s;
          float dO[8], us[2][8], xs[2][8], c[8], sn[8];
          ld_f32(us[0], P.dxq + r * kLdZ + f);
          ld_f32(us[1], P.dg + r * kLdZ + f);
          ld_bf16(dO, R.dout + r * kF + f);
          ld_bf16(xs[0], R.q + r * kF + f);
          ld_bf16(xs[1], R.k + r * kF + f);
          ld_f32(c, R.cos + r * kF + f);
          ld_f32(sn, R.sin + r * kF + f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            us[0][i] += dO[i];
            us[1][i] -= dv[s][i];
          }
          bf16* outs[2] = {A.dxq, A.dxk};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // rope VJP: u*cos - pair_swap(u)*sin, pair_swap(u) = (-u1, u0).
            float vv[8], ss = 0.f, proj = 0.f;
#pragma unroll
            for (int i = 0; i < 8; i += 2) {
              vv[i] = us[q][i] * c[i] + us[q][i + 1] * sn[i];
              vv[i + 1] = us[q][i + 1] * c[i + 1] - us[q][i] * sn[i + 1];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              ss += xs[q][i] * xs[q][i];
              proj += vv[i] * xs[q][i];
            }
            const float nrm = sqrtf(group_sum<kRowLanes>(ss));
            proj = group_sum<kRowLanes>(proj);
            const float m = fmaxf(nrm, 1e-12f);
            const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) vv[i] = vv[i] / m - xs[q][i] * corr;
            st_bf16(outs[q] + xo + kSlab * s * HF, vv);
          }
        }
      }
      if (j > 0) {  // one buffer: fetch step j - 1 once every thread is done with this one
        __syncthreads();
        fetch(n0, j - 1);
        hopper::cp_async_wait<0>();
        __syncthreads();
      }
    }
  }

  // Outputs: dW, db, and dln_w / dln_b reduced over the rows and warps.
  __syncthreads();
  if (cwarp) {
    float dw[kF / 8][4];
    load_carry(dw, S.carry, warp, lane);
    save_state(dw, db, A.dW + (size_t)bh * kF * kF, A.db + (size_t)bh * kF, warp, lane);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    accw[i] += __shfl_xor_sync(0xffffffffu, accw[i], 16);
    accb[i] += __shfl_xor_sync(0xffffffffu, accb[i], 16);
  }
  float* red = P.dzb;  // [2][8 warps][F]
  static_assert(2 * kWarps * kF <= kSlab * kLdZ, "the reduction fits the dzb tile");
  if (cwarp && lane < 16) {
    st_f32(red + warp * kF + f, accw);
    st_f32(red + kWarps * kF + warp * kF + f, accb);
  }
  __syncthreads();
  if (tid < kF) {
    float sw = 0.f, sb = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sw += red[w * kF + tid];
      sb += red[kWarps * kF + w * kF + tid];
    }
    A.dlnw[(size_t)bh * kF + tid] = sw;
    A.dlnb[(size_t)bh * kF + tid] = sb;
  }
}

}  // namespace

// Shared memory of the instantiation for mini-batch cs (an error code for a CS it is not built for).
extern "C" int ttt_linear_backward_f128_smem_bytes(int cs) {
  return with_mini_batch(cs, [](auto c) { return (int)sizeof(Smem<decltype(c)::value / kSlab>); });
}

// Bytes a step of the pass-A stash takes in the bf16 workspace (part 0) and the float32 one (part 1) at
// mini-batch cs.
extern "C" int ttt_linear_backward_f128_stash_bytes(int part, int cs) {
  return with_mini_batch(cs, [&](auto c) {
    constexpr int NS = decltype(c)::value / kSlab;
    return part == 0 ? (int)sizeof(StashH<NS>) : (int)sizeof(StashF<NS>);
  });
}

extern "C" int ttt_linear_backward_f128(const void* xq, const void* xk, const void* xv, const void* gate,
                                        const void* rope_cos, const void* rope_sin, const void* ln_w,
                                        const void* ln_b, const void* w_ck, const void* b_ck, const void* dout,
                                        void* dxq, void* dxk, void* dxv, void* dgate, void* dW, void* db,
                                        void* dlnw, void* dlnb, void* stash_w, void* stash_b, int B, int NC, int H,
                                        int CS, int K, float eta_scale, void* stream) {
  const BwdArgs A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                   static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                   static_cast<const float*>(rope_sin), NC, H, eta_scale},
                  static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(w_ck),
                  static_cast<const float*>(b_ck), static_cast<const bf16*>(dout), static_cast<bf16*>(dxq),
                  static_cast<bf16*>(dxk), static_cast<bf16*>(dxv), static_cast<float*>(dgate),
                  static_cast<float*>(dW), static_cast<float*>(db), static_cast<float*>(dlnw),
                  static_cast<float*>(dlnb), stash_w, stash_b, K};
  return with_mini_batch(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value;
    constexpr int kBytes = sizeof(Smem<kMiniBatch / kSlab>);
    cudaError_t err = cudaFuncSetAttribute(ttt_linear_bwd_f128_kernel<kMiniBatch>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ttt_linear_bwd_f128_kernel<kMiniBatch><<<B * H, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
