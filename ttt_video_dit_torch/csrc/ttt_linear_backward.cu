// Fused TTT-linear backward (K6), head_dim F = 64, mini-batch CS = 8, 16,
// ..., 64 (one instantiation each, ttt_mlp_block.cuh:with_slabs), for Hopper
// (sm_90a).
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_backward.py:_linear_bwd_kernel
// (launched by ttt_linear_backward, l.594, and reduced by
// ttt_vjp.py:_linear_bwd_pre), in its fused-preprocessing, token-major,
// in-kernel-gate form. It is the VJP of the training forward scan
// (ttt_linear_forward.cu with K > 0) from that kernel's fp32 state
// checkpoints: per (batch, head) it walks the checkpoint groups last to
// first (the ragged group first); per group, pass A re-runs the forward from
// the group's checkpoint and stashes each step's operands, and pass B walks
// the group backwards through the hand-derived step VJP (ttt_backward.py:
// 510-565): the output LN, the dual-form products, the second-order LN term,
// the target LN, rope and L2-norm VJPs and the sigmoid gate, d_gate = de *
// eta * (1 - sigmoid).
//
// What bounds it on the H100: as in the forward, the scan is sequential, so
// one block owns one (batch, head) and the limit is the latency of one step
// inside an SM: pass A's forward step, then pass B's ten small products and
// three row passes, each waiting on the one before. Device memory is not the
// limit. At B = 1 the grid is 48 blocks on 132 SMs.
//
// Design: one block of 8 warps per (batch, head); every product runs on the
// tensor cores (mma.sync m16n8k16, operands rounded to bf16 where the Pallas
// kernel calls .astype(dt): XQ, XK, W, Gs, A1, dZb1, dA1, the carry dW, dZ1;
// fp32 accumulation).
// - Pass A is ttt_linear_step.cuh's step without the output: warps 0-3 keep
//   the state W^T in registers, warps 4-7 prepare the next mini-batch. Each
//   step writes what pass B needs to an L2-resident workspace (24.75 KiB a
//   step at CS 16, 78 KiB at CS 64, so any K works): bf16(W^T) and b before
//   the step, XQ, XK, -A1 (the producer's fragments), Gs, Z1 and Z1_bar, as
//   byte images of the tiles.
// - Pass B thus recomputes no forward product. Its 8 warps take a step in
//   four phases with one block barrier after each: (P0) the row pass of the
//   preprocessing and the output LN's VJP (dZb1); (P5) the products of
//   dZb1: warps 0-3 hold the carry dW^T in registers in the state's layout
//   (rows c = 16 w ..) and compute dG = -A1^T dZb1c - db - XK bf16(dW) and
//   dW^T += dZb1c^T XQ for their 16 columns, warps 4-7 compute dXQ =
//   dZb1c W^T + dA1 XK and start dXK = -Gs bf16(dW)^T + dA1^T XQ for theirs
//   (dA1 = bf16(-dZb1c Gs^T) recomputed as A fragments, one 16 x 16 block
//   at a time and in each of the four warps, A1^T and dA1^T by movmatrix);
//   every product runs over the NS slabs of 16 tokens, block by block, as in
//   the forward step; (P6) the row pass of the LN-L2 VJP, the target LN's VJP,
//   dXV and d_gate (dZ1); (P7) dW^T += dZ1c^T XK and db in warps 0-3 (which
//   then write bf16(dW^T) for the next step's dXK), dXK += dZ1c W^T in warps
//   4-7; then the rope and L2-norm VJPs of dXQ and dXK run as the next
//   step's first row pass. At CS 16 and 32 the next step's raw rows and
//   stash are cp.async'd into a second buffer during P5-P7; at CS 48 and 64
//   one buffer is all that fits, so they are fetched after P8 and waited for
//   before the next P0 (kBufB).
// - Row passes: warp w takes rows 16 s + 2 w and 16 s + 2 w + 1 of every
//   slab s, 16 lanes a row, 4 features a lane; what a row's P0 computes for
//   P6 and P8 (the target, t_hat, its std, eta, the gate's sigmoid, dXV)
//   stays in registers, NS rows' worth. In a half slab (CS 8, 24, 40, 56)
//   warps 4-7 own only padding: P0 and P6 write its rows of dZb1 and dZ1 as
//   0 (they enter sums over tokens), and nothing of it is loaded or stored;
//   pass A's stash holds it as the step left it (XQ = XK = Gs = 0 there).
// - Shared memory: pass A's ring and tiles and pass B's buffers are one
//   union (the two passes never overlap), and pass B's tiles share storage
//   by lifetime (dZb1 and dZ1, their bf16 copies, dG and dXK), so CS 64 fits:
//   ~211 KiB there, ~104 KiB at CS 16. The LN-parameter cotangents are summed per lane over its
//   rows and the whole scan and reduced across the warps once at the end; the
//   LN and bias gradients come out compact ([F]) per (batch, head), and the
//   wrapper sums them over the batch.
//
// Layouts: as ttt_linear_forward.cu; dout/dxq/dxk/dxv [B, NC, CS, H*F] bf16;
// dgate [B, H, NC, CS] f32; checkpoints W1 [B, H, NG, F, F], b1
// [B, H, NG, 1, F] f32; outputs dW1 [B, H, F, F], db1 [B, H, 1, F],
// dln_w/dln_b [B, H, F] f32; workspaces [B, H, K] of StashH and of StashF.
// Every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_linear_step.cuh"

namespace {

using namespace tttl;

// Pass B's buffers of the next step's raw rows and stash: two, but one at CS 48 and 64 (see the top).
template <int NS>
constexpr int kBufB = NS <= 2 ? 2 : 1;

template <int NS>
struct PassA {
  static constexpr int kCS = kSlab * NS;
  RawStage<NS> raw[kRawSlots<NS>];  // the producer's ring
  PrepStage<NS> prep[2];            // the prepared ring
  float z[kCS * kLdZ];              // Z1
  bf16 gs[kCS * kLdB];              // Gs
};

template <int NS>
struct PassB {
  static constexpr int kCS = kSlab * NS;
  RawStageB<NS> raw[kBufB<NS>];  // the step's raw rows (+ dout)
  StashH<NS> sh[kBufB<NS>];      // ... and its stash
  StashF<NS> sf[kBufB<NS>];
  float dzb[kCS * kLdZ];         // dZb1 (P0 -> P5), then dZ1 (P6 -> P7)
  float dg[kCS * kLdZ];          // dG (P5 -> P6), then dXK (P7 -> P8)
  float dxq[kCS * kLdZ];         // dXQ (P5 -> P8)
  bf16 dzbc[kCS * kLdB];         // bf16(dZb1), then bf16(dZ1)
};

template <int NS>
struct Smem {
  union {
    PassA<NS> a;
    PassB<NS> b;
  } u;
  bf16 dwt[kF * kLdB];  // bf16(dW^T) of the carry
  uint64_t full[2], empty[2];
};
static_assert(sizeof(Smem<1>) <= 232448 && sizeof(Smem<2>) <= 232448 && sizeof(Smem<3>) <= 232448 &&
                  sizeof(Smem<4>) <= 232448,
              "exceeds the 227 KB shared-memory opt-in");

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

// The step VJP's row passes: row 16 s + 2 warp + lane / 16, features 4 (lane % 16) .. + 3.
constexpr int kRowLanes = 16;

template <int CS>
__global__ void __launch_bounds__(kThreads, 1) ttt_linear_bwd_kernel(const BwdArgs A) {
  constexpr int NS = slabs(CS), kCS = kSlab * NS, KB = kBufB<NS>;  // kCS: the tiles' rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NS>& S = *reinterpret_cast<Smem<NS>*>(smem_raw);
  PassB<NS>& P = S.u.b;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC, K = A.K;
  const int NG = (NC + K - 1) / K;
  const bool cwarp = warp < kWarps;  // warps 0-3: the state in pass A, the carry dW^T in pass B
  const size_t HF = (size_t)A.a.H * kF;
  StashH<NS>* SH = static_cast<StashH<NS>*>(A.sh) + (size_t)bh * K;
  StashF<NS>* SF = static_cast<StashF<NS>*>(A.sf) + (size_t)bh * K;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&S.full[s], 128);
      hopper::mbar_init(&S.empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < kF * kLdB / 2; i += kThreads) reinterpret_cast<uint32_t*>(S.dwt)[i] = 0u;

  const int r0 = 2 * warp + (lane >> 4), f = 4 * (lane & 15);  // pass B's rows r0 + 16 s
  const int f8 = 8 * (lane & 7);                                // pass A's row features
  float lw[4], lb[4], lw8[8], lb8[8];
  ld_f32(lw, A.ln_w + (size_t)h * kF + f);
  ld_f32(lb, A.ln_b + (size_t)h * kF + f);
  ld_f32(lw8, A.ln_w + (size_t)h * kF + f8);
  ld_f32(lb8, A.ln_b + (size_t)h * kF + f8);
  float dw[8][4] = {};                      // warps 0-3: the carry dW^T (LinState's layout)
  float2 db[2] = {}, dbt[2] = {};           // ... and db, db_tot of the warp's columns
  float accw[4] = {}, accb[4] = {};         // dln_w / dln_b over this lane's rows
  const StepTiles TA{S.u.a.z, S.u.a.gs, nullptr};

  // cp.async step j's raw rows (with dout) and stash into buffer j % KB.
  auto fetch = [&](int n0, int j) {
    RawStageB<NS>& R = P.raw[j % KB];
    load_rows<CS>(R, R.dout, A.a, A.dout, b, h, n0 + j, 0, kCS, tid, kThreads);
    const uint4* srch = reinterpret_cast<const uint4*>(SH + j);
    uint4* dsth = reinterpret_cast<uint4*>(&P.sh[j % KB]);
    for (int i = tid; i < (int)(sizeof(StashH<NS>) / 16); i += kThreads) hopper::cp_async16(dsth + i, srch + i);
    const uint4* srcf = reinterpret_cast<const uint4*>(SF + j);
    uint4* dstf = reinterpret_cast<uint4*>(&P.sf[j % KB]);
    for (int i = tid; i < (int)(sizeof(StashF<NS>) / 16); i += kThreads) hopper::cp_async16(dstf + i, srcf + i);
    hopper::cp_async_commit();
  };

  int it = 0;  // mini-batches the pass-A ring has carried
  for (int gi = NG - 1; gi >= 0; --gi) {
    const int n0 = gi * K, valid = min(K, NC - n0);
    __syncthreads();  // the previous pass B is done with the ring and the tiles

    // ---------------- Pass A: the forward from checkpoint gi, stashing each step.
    if (!cwarp) {
      producer<CS>(S.u.a.raw, S.u.a.prep, S.full, S.empty, A.a, A.ln_w, A.ln_b, b, h, n0, valid, it, warp - kWarps,
                   lane, SH);
    } else {
      LinState st;
      const size_t ck = (size_t)bh * NG + gi;
      load_state(st, A.w_ck + ck * kF * kF, A.b_ck + ck * kF, warp, lane);
      for (int i = 0; i < valid; ++i) {
        const int s = (it + i) & 1;
        hopper::mbar_wait(&S.full[s], ((it + i) >> 1) & 1);
        step<CS, false, true>(st, S.u.a.prep[s], TA, lw8, lb8, nullptr, 0, SH + i, SF + i, warp, lane);
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
      const RawStageB<NS>& R = P.raw[j % KB];
      const StashH<NS>& SHj = P.sh[j % KB];
      const StashF<NS>& SFj = P.sf[j % KB];
      const size_t xo = ((size_t)b * NC + n) * CS * HF + (size_t)h * kF + r0 * HF + f;

      // P0: preprocessing of rows r0 + 16 s, kept for the VJPs (target, t_hat, its std, eta); out = XQ + LN(Zb1):
      // dZb1 and the LN-affine cotangents.
      float tgt[NS][4], that[NS][4], sdt[NS], eta[NS], sig[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int r = r0 + kSlab * s;
        if constexpr (kHalf<CS>) {
          if (r >= CS) {  // a half slab's padding (warps 4-7): dZb1 0
            const float zero[4] = {};
            st_f32(P.dzb + r * kLdZ + f, zero);
            st_bf16(P.dzbc + r * kLdB + f, zero);
            continue;
          }
        }
        float k[4], v[4], c[4], sn[4], xk[4], tt[4];
        ld_bf16(k, R.k + r * kF + f);
        ld_bf16(v, R.v + r * kF + f);
        ld_f32(c, R.cos + r * kF + f);
        ld_f32(sn, R.sin + r * kF + f);
        l2norm_rope<kRowLanes>(xk, k, c, sn);
#pragma unroll
        for (int i = 0; i < 4; ++i) tt[i] = v[i] - xk[i];
        sdt[s] = target_ln<kRowLanes>(that[s], tt);
#pragma unroll
        for (int i = 0; i < 4; ++i) tgt[s][i] = lw[i] * that[s][i] + lb[i];
        sig[s] = 1.f / (1.f + expf(-R.gate[r]));
        eta[s] = sig[s] * A.a.eta_scale;

        float zb[4], xh[4], dO[4], wv[4], dz[4];
        ld_f32(zb, SFj.zb1 + r * kLdZ + f);
        ld_bf16(dO, R.dout + r * kF + f);
        const float sd = ln_stats<kRowLanes>(xh, zb);
        float mw = 0.f, mwx = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wv[i] = lw[i] * dO[i];
          mw += wv[i];
          mwx += wv[i] * xh[i];
        }
        mw = group_sum<kRowLanes>(mw) * (1.f / kF);
        mwx = group_sum<kRowLanes>(mwx) * (1.f / kF);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dz[i] = (wv[i] - mw - xh[i] * mwx) / sd;
          accw[i] += dO[i] * xh[i];
          accb[i] += dO[i];
        }
        st_f32(P.dzb + r * kLdZ + f, dz);
        st_bf16(P.dzbc + r * kLdB + f, dz);
      }
      __syncthreads();  // (A) dZb1
      if (KB == 2 && j > 0) fetch(n0, j - 1);

      // P5: the products of dZb1c.
      float xk[NS][2][4] = {};  // warps 4-7: dXK of their 16 columns, every slab, until P7
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
            uint32_t ak[4];
            lda(ak, SHj.xk, kSlab * s, 16 * kk, lane);
            negate(ak);
#pragma unroll
            for (int u = 0; u < 2; ++u) mma_bf16_16816(dg[u], ak, state_b(dw, u, 2 * kk), state_b(dw, u, 2 * kk + 1));
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) dg[u][e] -= (e & 1) ? dbt[u].y : dbt[u].x;
          store_block(P.dg + kSlab * s * kLdZ, dg, c0, lane);
        }
        // dW^T += dZb1c^T XQ (after dG read the carry)
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) {
          const uint32_t a[4] = {bz[jj][0], bz[jj][2], bz[jj][1], bz[jj][3]};
          update_rows(dw, a, SHj.xq + kSlab * jj * kLdB, lane);
        }
      } else {
        const int k0 = 16 * (warp - kWarps);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float da[NS][2][4] = {}, xq[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < kF / 16; ++kk) {
            uint32_t az[4], wb[4], ag[4], dwb[4];
            lda(az, P.dzbc, kSlab * s, 16 * kk, lane);
#pragma unroll
            for (int jj = 0; jj < NS; ++jj) {
              uint32_t gb[4];
              ldb_nk(gb, SHj.gs, kSlab * jj, 16 * kk, lane);
              mma_bf16_16816(da[jj][0], az, gb[0], gb[1]);  // dZb1c Gs^T, block (s, jj)
              mma_bf16_16816(da[jj][1], az, gb[2], gb[3]);
            }
            ldb_kn(wb, SHj.wt, 16 * kk, k0, lane);
            mma_bf16_16816(xq[0], az, wb[0], wb[1]);  // dZb1c W^T
            mma_bf16_16816(xq[1], az, wb[2], wb[3]);
            lda(ag, SHj.gs, kSlab * s, 16 * kk, lane);
            negate(ag);
            ldb_kn(dwb, S.dwt, 16 * kk, k0, lane);
            mma_bf16_16816(xk[s][0], ag, dwb[0], dwb[1]);  // -Gs bf16(dW)^T
            mma_bf16_16816(xk[s][1], ag, dwb[2], dwb[3]);
          }
          // dA1 = bf16(-dZb1c Gs^T) block by block as A fragments; dXQ += dA1 XK; dXK += dA1^T XQ.
#pragma unroll
          for (int jj = 0; jj < NS; ++jj) {
            const uint32_t dA[4] = {pack_bf16(-da[jj][0][0], -da[jj][0][1]), pack_bf16(-da[jj][0][2], -da[jj][0][3]),
                                    pack_bf16(-da[jj][1][0], -da[jj][1][1]), pack_bf16(-da[jj][1][2], -da[jj][1][3])};
            uint32_t dAt[4], xb[4];
            ldb_kn(xb, SHj.xk, kSlab * jj, k0, lane);
            mma_bf16_16816(xq[0], dA, xb[0], xb[1]);
            mma_bf16_16816(xq[1], dA, xb[2], xb[3]);
            transpose_a(dAt, dA);
            ldb_kn(xb, SHj.xq, kSlab * s, k0, lane);
            mma_bf16_16816(xk[jj][0], dAt, xb[0], xb[1]);
            mma_bf16_16816(xk[jj][1], dAt, xb[2], xb[3]);
          }
          store_block(P.dxq + kSlab * s * kLdZ, xq, k0, lane);
        }
      }
      __syncthreads();  // (B) dG, dXQ

      // P6: Gs = eta g1: de, dg1; g1 = ln_fused_l2(Z1, target): dZ1, dtarget; target = LN(XV - XK): dXV;
      //     d_gate = de * eta * (1 - sigmoid).
      float dv[NS][4];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int r = r0 + kSlab * s;
        if constexpr (kHalf<CS>) {
          if (r >= CS) {  // the padding: dZ1 0, no dXV or d_gate
            const float zero[4] = {};
            st_f32(P.dzb + r * kLdZ + f, zero);
            st_bf16(P.dzbc + r * kLdB + f, zero);
            continue;
          }
        }
        float z1[4], zh[4], gx[4], g1[4], dG[4], u[4], dgx[4], dxh[4], dz[4];
        ld_f32(z1, SFj.z1 + r * kLdZ + f);
        ld_f32(dG, P.dg + r * kLdZ + f);
        const float sd = ln_stats<kRowLanes>(zh, z1);
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gx[i] = lw[i] * ((lw[i] * zh[i] + lb[i]) - tgt[s][i]);
          m1 += gx[i];
          m2 += gx[i] * zh[i];
        }
        m1 = group_sum<kRowLanes>(m1) * (1.f / kF);
        m2 = group_sum<kRowLanes>(m2) * (1.f / kF);
        float de = 0.f, mu = 0.f, mux = 0.f, sug = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
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
        for (int i = 0; i < 4; ++i) {
          dgx[i] = (u[i] - mu - zh[i] * mux) / sd;
          dxh[i] = -(m2 * u[i] + gx[i] * mux) / sd + lw[i] * lw[i] * dgx[i];
          mdx += dxh[i];
          mdxx += dxh[i] * zh[i];
        }
        mdx = group_sum<kRowLanes>(mdx) * (1.f / kF);
        mdxx = group_sum<kRowLanes>(mdxx) * (1.f / kF);
        float gg[4], mg = 0.f, sgt = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
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
        for (int i = 0; i < 4; ++i) dv[s][i] = (gg[i] - mg) / sdt[s] - that[s][i] * (sgt / ((kF - 1) * sqrtv));
        st_f32(P.dzb + r * kLdZ + f, dz);
        st_bf16(P.dzbc + r * kLdB + f, dz);
        st_bf16(A.dxv + xo + kSlab * s * HF, dv[s]);
        if ((lane & 15) == 0) A.dgate[(((size_t)b * A.a.H + h) * NC + n) * CS + r] = de * eta[s] * (1.f - sig[s]);
      }
      __syncthreads();  // (C) dZ1

      // P7: dW^T += dZ1c^T XK; db = db_tot + colsum(dZ1); dXK += dZ1c W^T.
      if (cwarp) {
        const int c0 = 16 * warp;
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
      } else {
        const int k0 = 16 * (warp - kWarps);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
#pragma unroll
          for (int kk = 0; kk < kF / 16; ++kk) {
            uint32_t az[4], wb[4];
            lda(az, P.dzbc, kSlab * s, 16 * kk, lane);
            ldb_kn(wb, SHj.wt, 16 * kk, k0, lane);
            mma_bf16_16816(xk[s][0], az, wb[0], wb[1]);
            mma_bf16_16816(xk[s][1], az, wb[2], wb[3]);
          }
          store_block(P.dg + kSlab * s * kLdZ, xk[s], k0, lane);  // dXK
        }
      }
      hopper::cp_async_wait<0>();  // step j - 1's rows and stash (two buffers)
      __syncthreads();  // (D) dXK, bf16(dW^T)

      // P8: rope and L2-norm VJPs back to the raw projections.
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int r = r0 + kSlab * s;
        if constexpr (kHalf<CS>) {
          if (r >= CS) continue;
        }
        float dO[4], us[2][4], xs[2][4], c[4], sn[4];
        ld_f32(us[0], P.dxq + r * kLdZ + f);
        ld_f32(us[1], P.dg + r * kLdZ + f);
        ld_bf16(dO, R.dout + r * kF + f);
        ld_bf16(xs[0], R.q + r * kF + f);
        ld_bf16(xs[1], R.k + r * kF + f);
        ld_f32(c, R.cos + r * kF + f);
        ld_f32(sn, R.sin + r * kF + f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          us[0][i] += dO[i];
          us[1][i] -= dv[s][i];
        }
        bf16* outs[2] = {A.dxq, A.dxk};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // rope VJP: u*cos - pair_swap(u)*sin, pair_swap(u) = (-u1, u0).
          float vv[4], ss = 0.f, proj = 0.f;
#pragma unroll
          for (int i = 0; i < 4; i += 2) {
            vv[i] = us[q][i] * c[i] + us[q][i + 1] * sn[i];
            vv[i + 1] = us[q][i + 1] * c[i + 1] - us[q][i] * sn[i + 1];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ss += xs[q][i] * xs[q][i];
            proj += vv[i] * xs[q][i];
          }
          const float nrm = sqrtf(group_sum<kRowLanes>(ss));
          proj = group_sum<kRowLanes>(proj);
          const float m = fmaxf(nrm, 1e-12f);
          const float corr = nrm > 1e-12f ? proj / (m * m * fmaxf(nrm, 1e-20f)) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) vv[i] = vv[i] / m - xs[q][i] * corr;
          st_bf16(outs[q] + xo + kSlab * s * HF, vv);
        }
      }
      if (KB == 1 && j > 0) {  // one buffer: fetch step j - 1 once every thread is done with this one
        __syncthreads();
        fetch(n0, j - 1);
        hopper::cp_async_wait<0>();
        __syncthreads();
      }
    }
  }

  // Outputs: dW, db, and dln_w / dln_b reduced over the rows and warps.
  __syncthreads();
  if (cwarp) save_state(dw, db, A.dW + (size_t)bh * kF * kF, A.db + (size_t)bh * kF, warp, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    accw[i] += __shfl_xor_sync(0xffffffffu, accw[i], 16);
    accb[i] += __shfl_xor_sync(0xffffffffu, accb[i], 16);
  }
  float* red = P.dzb;  // [2][8 warps][F]
  static_assert(2 * 8 * kF <= kSlab * kLdZ, "the reduction fits the dzb tile");
  if (lane < 16) {
    st_f32(red + warp * kF + f, accw);
    st_f32(red + 8 * kF + warp * kF + f, accb);
  }
  __syncthreads();
  if (tid < kF) {
    float sw = 0.f, sb = 0.f;
    for (int w = 0; w < 8; ++w) {
      sw += red[w * kF + tid];
      sb += red[8 * kF + w * kF + tid];
    }
    A.dlnw[(size_t)bh * kF + tid] = sw;
    A.dlnb[(size_t)bh * kF + tid] = sb;
  }
}

}  // namespace

// Shared memory of the instantiation for mini-batch cs (an error code for a CS it is not built for).
extern "C" int ttt_linear_backward_smem_bytes(int cs) {
  return with_slabs(cs, [](auto c) { return (int)sizeof(Smem<slabs(decltype(c)::value)>); });
}

// Bytes a step of the pass-A stash takes in the bf16 workspace (part 0) and the float32 one (part 1) at
// mini-batch cs.
extern "C" int ttt_linear_backward_stash_bytes(int part, int cs) {
  return with_slabs(cs, [&](auto c) {
    constexpr int NS = slabs(decltype(c)::value);
    return part == 0 ? (int)sizeof(StashH<NS>) : (int)sizeof(StashF<NS>);
  });
}

extern "C" int ttt_linear_backward(const void* xq, const void* xk, const void* xv, const void* gate,
                                   const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                   const void* w_ck, const void* b_ck, const void* dout, void* dxq, void* dxk,
                                   void* dxv, void* dgate, void* dW, void* db, void* dlnw, void* dlnb, void* stash_w,
                                   void* stash_b, int B, int NC, int H, int CS, int K, float eta_scale, void* stream) {
  const BwdArgs A{{static_cast<const bf16*>(xq), static_cast<const bf16*>(xk), static_cast<const bf16*>(xv),
                   static_cast<const float*>(gate), static_cast<const float*>(rope_cos),
                   static_cast<const float*>(rope_sin), NC, H, eta_scale},
                  static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(w_ck),
                  static_cast<const float*>(b_ck), static_cast<const bf16*>(dout), static_cast<bf16*>(dxq),
                  static_cast<bf16*>(dxk), static_cast<bf16*>(dxv), static_cast<float*>(dgate),
                  static_cast<float*>(dW), static_cast<float*>(db), static_cast<float*>(dlnw),
                  static_cast<float*>(dlnb), stash_w, stash_b, K};
  return with_slabs(CS, [&](auto c) {
    constexpr int kMiniBatch = decltype(c)::value;
    constexpr int kBytes = sizeof(Smem<slabs(kMiniBatch)>);
    cudaError_t err =
        cudaFuncSetAttribute(ttt_linear_bwd_kernel<kMiniBatch>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ttt_linear_bwd_kernel<kMiniBatch><<<B * H, kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
