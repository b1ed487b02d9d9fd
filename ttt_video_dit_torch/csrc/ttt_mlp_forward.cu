// Fused TTT-MLP forward scan, head_dim F = 64, for Hopper (sm_90a): the
// sampling kernel (mini-batch CS = 16, no state checkpoints) and, at the end
// of this file, the training kernel (CS = 8, 16, ..., 64, one instantiation
// each; fp32 state checkpoints every K mini-batches for the backward,
// csrc/ttt_mlp_backward.cu). Sampling at every other CS runs the training
// kernel with no checkpoints (K = 0): the entry ttt_mlp_forward picks the
// kernel by CS.
//
// Replaces: ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_mlp_kernel with
// _fused_preproc and _eta_from_gate (launched by ttt_mlp_forward, reached
// through ttt_vjp.py:ttt_mlp_fused_pre and ttt_mlp_kernel.py:ttt_mlp), in its
// token-major, fused-preprocessing form. Per (batch, head) it walks the NC
// mini-batches in order: L2-norm + rope of the raw q/k projections, the
// LN-reconstruction target from v - k, eta = sigmoid(gate) * eta_scale, one
// dual-form update of the two-layer GELU fast-weight MLP (W1 [F,4F], b1,
// W2 [4F,F], b2; fp32 state), and out = XQ + LN(Z2_bar).
//
// What bounds it on the H100: the scan is sequential in NC, so one block owns
// one (batch, head) scan and the limit is the latency of one mini-batch step
// inside an SM, not device memory (a step reads ~6 KiB and writes 2 KiB) and
// not the card's FLOP/s (a step is ~4 Mflop, under a microsecond on one SM's
// tensor cores). At B = 2 the grid is 96 blocks on 132 SMs. What a step costs
// is its chain of dependent products, the shared-memory traffic between them
// and the waits across warps.
//
// Design (one block per scan: 8 consumer warps and a producer warpgroup):
// - Every product runs on the tensor cores, mma.sync m16n8k16 (bf16 operands,
//   fp32 accumulation); CS = 16 is one m16 tile. Operands are rounded to bf16
//   exactly where _mlp_kernel rounds them (XQ/XK after preprocessing, every
//   W.astype(dt), X2c, bf16(grad_z2), G1, G2, attn1, attn2, X2_barc), so only
//   the fp32 summation order differs from the plain version.
// - The fp32 state lives in registers in the mma accumulator layout. Warp w
//   owns hidden units 32w..32w+31: the matching 32 rows of W1^T and of W2
//   (64 + 64 fp32 registers a thread). Held as W1^T, the accumulator of the
//   update W1^T -= G1^T XK is, packed to bf16 pairs (cvt.rn.bf16x2), the B
//   fragment of Z1 = XK W1 and Z1_bar = XQ W1; W2's accumulator is the B
//   fragment of grad_z1 = grad_z2 W2^T as it stands and, after one movmatrix
//   per 8 x 8 block, of Z2 = X2c W2 and Z2_bar. G1, gelu'(Z1), b1 and the W1
//   update for a warp's hidden units never leave the warp; G1^T and X2c^T
//   (the A operands of the updates, and G1 as the B of attn1 G1) are
//   movmatrix transposes of the warp's own fragments.
// - Three named-barrier waits a step among the consumer warps, plus the wait
//   for the prepared mini-batch: (1) Z2's partial sums over the warps' hidden
//   units are in shared memory; (2) grad_z2 and G2 (row-wise LN backward,
//   each warp two rows) are; (3) Z2_bar's and attn2's partial sums are.
//   Each warp then finishes two rows (attn2 @ G2, b2, LN) and stores them.
// - The producer warpgroup prepares the next mini-batch while the consumers
//   run this one: each of its warps cp.async-loads 4 rows of q/k/v, gate and
//   rope one mini-batch further ahead into a raw ring, then computes their
//   L2-norm, rope, target LN and eta; after a named barrier among the four,
//   one warp computes attn1 = bf16(XQ XK^T) on the tensor cores. The results
//   go into a two-stage ring of prepared mini-batches, each stage signalled
//   on an mbarrier ("full") and released by the consumers on another
//   ("empty"). Output rows go out as plain stores nobody waits on.
// - Registers: 12 warps put 3 on each of the SM's four schedulers, which
//   caps a thread at 168 registers at launch; setmaxnreg then moves the
//   producers' (down to 40) to the consumers (up to 232), whose state alone
//   is 128. With 168 for every warp, or the producers cut to 24, ptxas
//   spilled over 500 bytes a thread and the kernel ran 1.7-2.2x slower on
//   the H100 (PERF.md).
//
// Layouts: xq/xk/xv/out [B, NC, CS, H*F] bf16 (head h = columns h*F..h*F+F);
// gate [B, H, NC, CS] f32 (pre-sigmoid logits); rope cos/sin [NC, CS, F] f32
// (interleaved, identity rows on text slots); ln_w/ln_b [H, F] f32;
// W1 [H, F, 4F], b1 [H, 1, 4F], W2 [H, 4F, F], b2 [H, 1, F] f32 (the initial
// state, shared by every batch element). Every pointer 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ttt_mlp_block.cuh"
#include "ttt_mlp_train_step.cuh"

namespace {

constexpr int kF = 64;
constexpr int kF4 = 4 * kF;
constexpr int kCS = 16;
constexpr int kWarps = 8;                     // consumer warps
constexpr int kCols = kF4 / kWarps;           // hidden units a consumer warp owns
constexpr int kConsumers = 32 * kWarps;       // consumer threads
constexpr int kThreads = kConsumers + 128;    // + the producer warpgroup
// Registers a thread: 168 at launch (12 warps, 3 on each of the SM's four
// schedulers); setmaxnreg then moves the producer warpgroup's to the consumers.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kLdB = kF + 8;   // row stride of the bf16 [CS][F] tiles (144 bytes: ldmatrix without bank conflicts)
constexpr int kLdP = kF + 8;   // row stride of the fp32 [CS][F] partial sums
constexpr int kLdA = kCS + 8;  // row stride of the fp32 [CS][CS] partial sums
constexpr int kStages = 2;
constexpr int kConsumerBar = 1;  // named barrier of the consumer warps
constexpr uint32_t kSignBits = 0x80008000u;
static_assert(kCols == 32, "the fragment maps below assume 32 hidden units a warp");

struct RawStage {  // one mini-batch as loaded, for one (batch, head)
  __nv_bfloat16 q[kCS * kF], k[kCS * kF], v[kCS * kF];
  float cos[kCS * kF], sin[kCS * kF];
  float gate[kCS];
};

struct PrepStage {  // one mini-batch as the step takes it
  __nv_bfloat16 xq[kCS * kLdB], xk[kCS * kLdB];  // bf16(XQ), bf16(XK)
  float tgt[kCS * kF];                            // LN-reconstruction target
  float eta[kCS];
  uint32_t neg_attn1[32 * 4];  // -bf16(XQ XK^T) as mma A fragments, lane-major
};

struct Smem {
  RawStage raw[kStages];
  PrepStage prep[kStages];
  float z2p[kWarps][kCS * kLdP];   // each warp's share of Z2
  float z2bp[kWarps][kCS * kLdP];  // ... of Z2_bar (without attn2 @ G2 and b2)
  float a2p[kWarps][kCS * kLdA];   // ... of attn2
  __nv_bfloat16 gz2[kCS * kLdB];   // bf16(grad_z2)
  __nv_bfloat16 g2[kCS * kLdB];    // G2 = bf16(eta * grad_z2)
  uint64_t full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem);
static_assert(kSmemBytes <= 232448, "exceeds the 227 KB shared-memory opt-in");
static_assert(sizeof(RawStage) % 16 == 0 && sizeof(PrepStage) % 16 == 0, "16-byte aligned stages");

struct Args {
  const __nv_bfloat16 *xq, *xk, *xv;
  const float *gate, *rope_cos, *rope_sin, *ln_w, *ln_b, *W1, *b1, *W2, *b2;
  __nv_bfloat16* out;
  int NC, H;
  float eta_scale;
};

using hopper::ldsm_row;
using hopper::mma_bf16_16816;
using hopper::movmatrix_trans;
using hopper::pack_bf16;
using tttb::bf16r;
using tttb::gelu_and_grad;
using tttb::warp_sum;
using ttts::fence_state;

__device__ __forceinline__ float2 bf2f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// ---- producer (4 warps; warp pw prepares rows 4 pw .. 4 pw + 3 of each mini-batch)
constexpr int kRowsPerProducer = kCS / 4;
constexpr int kProducerBar = 2;  // named barrier of the producer warpgroup

__device__ __forceinline__ void load_raw(RawStage& r, const Args& a, int b, int h, int n, int pw, int lane) {
  const size_t HF = (size_t)a.H * kF;
  const int row = kRowsPerProducer * pw + (lane >> 3), c = (lane & 7) * 8;  // 4 rows x 8 chunks of 16 bytes
  const size_t go = (((size_t)b * a.NC + n) * kCS + row) * HF + (size_t)h * kF + c;
  hopper::cp_async16(r.q + row * kF + c, a.xq + go);
  hopper::cp_async16(r.k + row * kF + c, a.xk + go);
  hopper::cp_async16(r.v + row * kF + c, a.xv + go);
  const size_t to = ((size_t)n * kCS + kRowsPerProducer * pw) * kF;
  const int i = kRowsPerProducer * pw * kF;
#pragma unroll
  for (int j = lane * 4; j < kRowsPerProducer * kF; j += 128) {
    hopper::cp_async16(r.cos + i + j, a.rope_cos + to + j);
    hopper::cp_async16(r.sin + i + j, a.rope_sin + to + j);
  }
  if (lane == 0) hopper::cp_async16(r.gate + kRowsPerProducer * pw, a.gate + (((size_t)b * a.H + h) * a.NC + n) * kCS + kRowsPerProducer * pw);
  hopper::cp_async_commit();
}

// L2-norm, rope, target LN and eta of this warp's rows (lane = features 2 lane, 2 lane + 1).
__device__ __forceinline__ void prepare_rows(PrepStage& p, const RawStage& r, float eta_scale, float2 lw, float2 lb,
                                             int pw, int lane) {
  const int f0 = 2 * lane;
#pragma unroll 2
  for (int row = kRowsPerProducer * pw; row < kRowsPerProducer * (pw + 1); ++row) {
    const float2 q = bf2f(r.q + row * kF + f0), k = bf2f(r.k + row * kF + f0), v = bf2f(r.v + row * kF + f0);
    const float2 c = *reinterpret_cast<const float2*>(r.cos + row * kF + f0);
    const float2 s = *reinterpret_cast<const float2*>(r.sin + row * kF + f0);
    // L2-norm: x / max(||x||, 1e-12); rope: x*cos + (x@R)*sin, (x@R) = (-x1, x0).
    const float dq = fmaxf(sqrtf(warp_sum(q.x * q.x + q.y * q.y)), 1e-12f);
    const float dk = fmaxf(sqrtf(warp_sum(k.x * k.x + k.y * k.y)), 1e-12f);
    const float qn0 = q.x / dq, qn1 = q.y / dq, kn0 = k.x / dk, kn1 = k.y / dk;
    const float XQ0 = qn0 * c.x + (-qn1) * s.x, XQ1 = qn1 * c.y + qn0 * s.y;
    const float XK0 = kn0 * c.x + (-kn1) * s.x, XK1 = kn1 * c.y + kn0 * s.y;
    // LN-reconstruction target: unbiased std, eps added to the std.
    const float t0 = v.x - XK0, t1 = v.y - XK1;
    const float mu = warp_sum(t0 + t1) * (1.f / kF);
    const float d0 = t0 - mu, d1 = t1 - mu;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) * ((float)kF / (kF - 1));
    const float sd = sqrtf(var) + 1e-8f;
    *reinterpret_cast<float2*>(p.tgt + row * kF + f0) = make_float2(lw.x * (d0 / sd) + lb.x, lw.y * (d1 / sd) + lb.y);
    st_bf2(p.xq + row * kLdB + f0, XQ0, XQ1);
    st_bf2(p.xk + row * kLdB + f0, XK0, XK1);
  }
  if (lane < kRowsPerProducer) {
    const int row = kRowsPerProducer * pw + lane;
    p.eta[row] = (1.f / (1.f + expf(-r.gate[row]))) * eta_scale;
  }
}

// attn1 = bf16(XQ XK^T) on the tensor cores, stored negated as the A fragment of the step's attn1 @ G1.
__device__ __forceinline__ void prepare_attn1(PrepStage& p, int lane) {
  float acc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kF / 16; ++kk) {
    uint32_t qa[4], kb[4];
    hopper::ldsm_x4(qa, ldsm_row(p.xq, kLdB, kk * 16, lane));
    // B = XK rows (k = feature, n = token): blocks (tokens 0-7, k), (0-7, k + 8), (8-15, k), (8-15, k + 8).
    hopper::ldsm_x4(kb, p.xk + ((lane & 7) + (lane >> 4) * 8) * kLdB + kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16_16816(acc[0], qa, kb[0], kb[1]);
    mma_bf16_16816(acc[1], qa, kb[2], kb[3]);
  }
  // The accumulator's two n-tiles are the A fragment of the 16 x 16 attn1.
  const uint4 na = make_uint4(pack_bf16(acc[0][0], acc[0][1]) ^ kSignBits, pack_bf16(acc[0][2], acc[0][3]) ^ kSignBits,
                              pack_bf16(acc[1][0], acc[1][1]) ^ kSignBits, pack_bf16(acc[1][2], acc[1][3]) ^ kSignBits);
  *reinterpret_cast<uint4*>(p.neg_attn1 + lane * 4) = na;
}

__device__ void producer(Smem& S, const Args& a, int b, int h, int pw, int lane) {
  const float2 lw = *reinterpret_cast<const float2*>(a.ln_w + (size_t)h * kF + 2 * lane);
  const float2 lb = *reinterpret_cast<const float2*>(a.ln_b + (size_t)h * kF + 2 * lane);
  load_raw(S.raw[0], a, b, h, 0, pw, lane);
  for (int n = 0; n < a.NC; ++n) {
    const int s = n & 1;
    __syncwarp();  // every lane is done with raw[s ^ 1] (mini-batch n - 1)
    if (n + 1 < a.NC) {
      load_raw(S.raw[s ^ 1], a, b, h, n + 1, pw, lane);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncwarp();  // this warp's rows of raw[s] (mini-batch n) have landed
    if (n >= kStages) hopper::mbar_wait(&S.empty[s], ((n >> 1) - 1) & 1);
    prepare_rows(S.prep[s], S.raw[s], a.eta_scale, lw, lb, pw, lane);
    hopper::named_sync(kProducerBar, 128);
    if (pw == 0) prepare_attn1(S.prep[s], lane);
    hopper::mbar_arrive(&S.full[s]);
  }
}

// ---- consumers
// Warp w, lane = 4 g + t. Register maps (hidden unit j = 32 w + ...):
//   w1[m][f][..]: W1^T rows j = 16 m + g (elements 0, 1) and 16 m + g + 8 (2, 3), features 8 f + 2t, 8 f + 2t + 1;
//   w2[m][f][..]: W2 rows j = 16 m + g (0, 1) and 16 m + g + 8 (2, 3), the same features;
//   per-token products over the warp's units ([16 tokens] x [32 units], n-tile u of 8 units): rows g (0, 1) and
//   g + 8 (2, 3), units 8 u + 2t, 8 u + 2t + 1; bias1[u][0..1] the matching b1.
// The B fragment (k = feature, n = unit) of X @ W1 for n-tile u, k-tile kk: pairs of w1[u / 2][2 kk (+1)], the row
// half u % 2; the same map on w2 gives the B fragment of grad_z2 @ W2^T.
__device__ __forceinline__ uint32_t state_b(const float (&w)[2][8][4], int u, int f) {
  const int m = u >> 1, half = (u & 1) * 2;
  return pack_bf16(w[m][f][half], w[m][f][half + 1]);
}

// acc[u] += A (16 x 64, bf16 row-major tile in shared memory) @ bf16(W) over the warp's 4 n-tiles of units.
__device__ __forceinline__ void tokens_by_state(float (&acc)[4][4], const __nv_bfloat16* tile,
                                                const float (&w)[2][8][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < kF / 16; ++kk) {
    uint32_t a[4];
    hopper::ldsm_x4(a, ldsm_row(tile, kLdB, kk * 16, lane));
#pragma unroll
    for (int u = 0; u < 4; ++u) mma_bf16_16816(acc[u], a, state_b(w, u, 2 * kk), state_b(w, u, 2 * kk + 1));
  }
}

// The warp's share of X @ bf16(W2) ([16 tokens] x [64 features], summed over its 32 units), written to ``dst``:
// A = x (the warp's [16] x [32] bf16 fragments, x[u][0] rows g, x[u][1] rows g + 8), B = W2's blocks transposed.
__device__ __forceinline__ void units_by_w2(float* dst, const uint32_t (&x)[4][2], const float (&w2)[2][8][4],
                                            int g, int t) {
#pragma unroll
  for (int f = 0; f < kF / 8; ++f) {
    float acc[4] = {};
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const uint32_t a[4] = {x[2 * kh][0], x[2 * kh][1], x[2 * kh + 1][0], x[2 * kh + 1][1]};
      mma_bf16_16816(acc, a, movmatrix_trans(pack_bf16(w2[kh][f][0], w2[kh][f][1])),
                     movmatrix_trans(pack_bf16(w2[kh][f][2], w2[kh][f][3])));
    }
    *reinterpret_cast<float2*>(dst + g * kLdP + 8 * f + 2 * t) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(dst + (g + 8) * kLdP + 8 * f + 2 * t) = make_float2(acc[2], acc[3]);
  }
}

// w[m][f] -= x^T @ y: x^T the A operand (negated transposes of the warp's [16 tokens] x [32 units] fragments),
// y a [16 tokens][64] bf16 row-major tile in shared memory as B.
__device__ __forceinline__ void update_state(float (&w)[2][8][4], const uint32_t (&xt)[4][2],
                                             const __nv_bfloat16* y, int lane) {
  uint32_t a[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    a[m][0] = xt[2 * m][0] ^ kSignBits;
    a[m][1] = xt[2 * m + 1][0] ^ kSignBits;
    a[m][2] = xt[2 * m][1] ^ kSignBits;
    a[m][3] = xt[2 * m + 1][1] ^ kSignBits;
  }
#pragma unroll
  for (int fp = 0; fp < kF / 16; ++fp) {
    uint32_t bb[4];
    hopper::ldsm_x4_trans(bb, ldsm_row(y, kLdB, fp * 16, lane));
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      mma_bf16_16816(w[m][2 * fp], a[m], bb[0], bb[1]);
      mma_bf16_16816(w[m][2 * fp + 1], a[m], bb[2], bb[3]);
    }
  }
}

__device__ void consumer(Smem& S, const Args& a, int b, int h, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3, f0 = 2 * lane;
  const int j0 = warp * kCols;  // the warp's first hidden unit
  const size_t HF = (size_t)a.H * kF;

  float w1[2][8][4], w2[2][8][4], bias1[4][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < 8; ++f)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = j0 + 16 * m + g + 8 * hr, c = 8 * f + 2 * t;
        w1[m][f][2 * hr] = a.W1[((size_t)h * kF + c) * kF4 + j];
        w1[m][f][2 * hr + 1] = a.W1[((size_t)h * kF + c + 1) * kF4 + j];
        const float2 v = *reinterpret_cast<const float2*>(a.W2 + ((size_t)h * kF4 + j) * kF + c);
        w2[m][f][2 * hr] = v.x;
        w2[m][f][2 * hr + 1] = v.y;
      }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 v = *reinterpret_cast<const float2*>(a.b1 + (size_t)h * kF4 + j0 + 8 * u + 2 * t);
    bias1[u][0] = v.x;
    bias1[u][1] = v.y;
  }
  float2 b2 = *reinterpret_cast<const float2*>(a.b2 + (size_t)h * kF + f0);
  const float2 lw = *reinterpret_cast<const float2*>(a.ln_w + (size_t)h * kF + f0);
  const float2 lb = *reinterpret_cast<const float2*>(a.ln_b + (size_t)h * kF + f0);

  for (int n = 0; n < a.NC; ++n) {
    const int s = n & 1;
    PrepStage& p = S.prep[s];
    hopper::mbar_wait(&S.full[s], (n >> 1) & 1);

    // Z1 = XK @ bf16(W1) + b1; keep gelu'(Z1) and X2c = bf16(gelu(Z1)).
    float z[4][4] = {}, gp[4][4];
    uint32_t x2[4][2];
    tokens_by_state(z, p.xk, w1, lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = gelu_and_grad(z[u][e] + bias1[u][e & 1], gp[u][e]);
      x2[u][0] = pack_bf16(y[0], y[1]);
      x2[u][1] = pack_bf16(y[2], y[3]);
    }
    // Z2's share: X2c @ bf16(W2) over the warp's units.
    units_by_w2(S.z2p[warp], x2, w2, g, t);
    fence_state(w1);
    fence_state(w2);
    hopper::named_sync(kConsumerBar, kConsumers);  // wait 1: Z2's shares

    // grad_z2 = ln_fused_l2_bwd(Z2, target) for rows 2 warp, 2 warp + 1 (eps 1e-8 on the biased var).
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(S.z2p[w] + r * kLdP + f0);
        x0 += v.x;
        x1 += v.y;
      }
      x0 += b2.x;
      x1 += b2.y;
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float xh0 = d0 / sd, xh1 = d1 / sd;
      const float2 tg = *reinterpret_cast<const float2*>(p.tgt + r * kF + f0);
      const float gx0 = (lw.x * xh0 + lb.x - tg.x) * lw.x;
      const float gx1 = (lw.y * xh1 + lb.y - tg.y) * lw.y;
      const float s1 = warp_sum(gx0 + gx1);
      const float s2 = warp_sum(gx0 * xh0 + gx1 * xh1);
      const float g0 = (1.f / kF) * (kF * gx0 - s1 - xh0 * s2) / sd;
      const float g1 = (1.f / kF) * (kF * gx1 - s1 - xh1 * s2) / sd;
      const float eta = p.eta[r];
      st_bf2(S.gz2 + r * kLdB + f0, g0, g1);
      st_bf2(S.g2 + r * kLdB + f0, eta * g0, eta * g1);
    }
    hopper::named_sync(kConsumerBar, kConsumers);  // wait 2: bf16(grad_z2) and G2

    // G1 = bf16(eta * (bf16(grad_z2) @ bf16(W2)^T * gelu'(Z1))) on the warp's units; b1 -= colsum(G1).
    uint32_t g1[4][2], g1t[4][2];
    {
      float gz[4][4] = {};
      tokens_by_state(gz, S.gz2, w2, lane);
      fence_state(w2);
      const float eta_lo = p.eta[g], eta_hi = p.eta[g + 8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        g1[u][0] = pack_bf16(eta_lo * (gz[u][0] * gp[u][0]), eta_lo * (gz[u][1] * gp[u][1]));
        g1[u][1] = pack_bf16(eta_hi * (gz[u][2] * gp[u][2]), eta_hi * (gz[u][3] * gp[u][3]));
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][0]));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g1[u][1]));
        float c0 = lo.x + hi.x, c1 = lo.y + hi.y;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, off);
          c1 += __shfl_xor_sync(0xffffffffu, c1, off);
        }
        bias1[u][0] -= c0;
        bias1[u][1] -= c1;
        // G1^T blocks: (unit 8u + g, tokens 2t, 2t + 1) and (..., tokens 8 + 2t, 9 + 2t).
        g1t[u][0] = movmatrix_trans(g1[u][0]);
        g1t[u][1] = movmatrix_trans(g1[u][1]);
      }
    }

    // Z1_bar = XQ @ bf16(W1) - attn1 @ G1 + b1 (the new b1); X2_barc = bf16(gelu(Z1_bar)).
    uint32_t xb[4][2];
    {
      float zb[4][4] = {};
      tokens_by_state(zb, p.xq, w1, lane);
      const uint4 nv = *reinterpret_cast<const uint4*>(p.neg_attn1 + lane * 4);
      const uint32_t na[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mma_bf16_16816(zb[u], na, g1t[u][0], g1t[u][1]);
        float y[4], unused;
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = gelu_and_grad(zb[u][e] + bias1[u][e & 1], unused);
        xb[u][0] = pack_bf16(y[0], y[1]);
        xb[u][1] = pack_bf16(y[2], y[3]);
      }
    }
    // W1^T -= G1^T @ XK.
    update_state(w1, g1t, p.xk, lane);

    // attn2's share: X2_barc @ X2c^T over the warp's units (B = X2c's own fragments).
    {
      float a2[2][4] = {};
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const uint32_t xa[4] = {xb[2 * kh][0], xb[2 * kh][1], xb[2 * kh + 1][0], xb[2 * kh + 1][1]};
        mma_bf16_16816(a2[0], xa, x2[2 * kh][0], x2[2 * kh + 1][0]);
        mma_bf16_16816(a2[1], xa, x2[2 * kh][1], x2[2 * kh + 1][1]);
      }
      float* dst = S.a2p[warp];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<float2*>(dst + g * kLdA + 8 * nt + 2 * t) = make_float2(a2[nt][0], a2[nt][1]);
        *reinterpret_cast<float2*>(dst + (g + 8) * kLdA + 8 * nt + 2 * t) = make_float2(a2[nt][2], a2[nt][3]);
      }
    }
    // Z2_bar's share: X2_barc @ bf16(W2); then W2 -= X2c^T @ G2.
    units_by_w2(S.z2bp[warp], xb, w2, g, t);
    {
      uint32_t x2t[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x2t[u][0] = movmatrix_trans(x2[u][0]);
        x2t[u][1] = movmatrix_trans(x2[u][1]);
      }
      update_state(w2, x2t, S.g2, lane);
    }
    hopper::named_sync(kConsumerBar, kConsumers);  // wait 3: Z2_bar's and attn2's shares

    // Rows 2 warp, 2 warp + 1: attn2 = bf16(sum of shares); b2 -= colsum(G2);
    // Z2_bar = shares - attn2 @ G2 + b2; out = XQ + LN(Z2_bar) (eps 1e-8 on the biased var).
    float ar[2] = {0.f, 0.f};
    if (lane < kCS) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ar[rr] += S.a2p[w][(2 * warp + rr) * kLdA + lane];
        ar[rr] = bf16r(ar[rr]);
      }
    }
    float2 cs = make_float2(0.f, 0.f), ag[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int sr = 0; sr < kCS; ++sr) {
      const float2 gv = bf2f(S.g2 + sr * kLdB + f0);
      cs.x += gv.x;
      cs.y += gv.y;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float as = __shfl_sync(0xffffffffu, ar[rr], sr);
        ag[rr].x += as * gv.x;
        ag[rr].y += as * gv.y;
      }
    }
    b2.x -= cs.x;
    b2.y -= cs.y;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 2 * warp + rr;
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 v = *reinterpret_cast<const float2*>(S.z2bp[w] + r * kLdP + f0);
        x0 += v.x;
        x1 += v.y;
      }
      x0 = (x0 - ag[rr].x) + b2.x;
      x1 = (x1 - ag[rr].y) + b2.y;
      const float mu = warp_sum(x0 + x1) * (1.f / kF);
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float sd = sqrtf(warp_sum(d0 * d0 + d1 * d1) * (1.f / kF) + 1e-8f);
      const float2 q = bf2f(p.xq + r * kLdB + f0);
      const size_t xo = (((size_t)b * a.NC + n) * kCS + r) * HF + (size_t)h * kF + f0;
      st_bf2(a.out + xo, q.x + (lw.x * (d0 / sd) + lb.x), q.y + (lw.y * (d1 / sd) + lb.y));
    }
    hopper::mbar_arrive(&S.empty[s]);  // this thread is done with prep[s]
  }
}

__global__ void __launch_bounds__(kThreads, 1) ttt_mlp_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&S.full[s], 128);         // every producer thread
      hopper::mbar_init(&S.empty[s], kConsumers);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= kWarps) {  // the producer warpgroup
    hopper::reg_dealloc<kProducerRegs>();
    producer(S, a, b, h, warp - kWarps, lane);
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    consumer(S, a, b, h, warp, lane);
  }
}

}  // namespace

// ---------------------------------------------------------------- training
//
// ttt_mlp_fwd_train_kernel<CS> (K1-train): the same scan at mini-batch
// CS = 8, 16, ..., 64, in NS = ceil(CS / 16) slabs (ttt_mlp_block.cuh:
// with_slabs). Before mini-batch n with n % K == 0 it writes the fp32 state
// (W1, b1, W2, b2; one bias row, not the TPU's 8 rows x 0.125) as checkpoint
// n / K; the last group may be shorter than K. With K = 0 it writes none: that
// is K1 (sampling) at every CS but 16, at the CFG batch B = 2 (96 blocks).
//
// What bounds it: as for the sampling kernel, the latency of one step inside
// one SM (the scan is sequential; a CS-64 step is ~20 Mflop and reads
// ~40 KiB), at B = 1 on 48 of the 132 SMs.
//
// Design: ttt_mlp_train_step.cuh's tensor-core step with the output. One
// block of 12 warps per (batch, head): 8 consumer warps hold the fp32 state in
// registers and run the step; the producer warpgroup (4 warps, CS / 4 rows
// each) reads the raw q/k/v, gate and rope rows of the next mini-batch from
// device memory and prepares them (L2-norm, rope, target LN, eta) into a
// two-stage ring signalled by full/empty mbarriers: bf16 XQ/XK and eta in
// shared memory, the fp32 targets (4 NS KiB a stage) in a workspace of two
// stages a scan that stays in the L2. The step's tiles stay in shared memory
// (TrainSmem<NS>: ~208 KiB at CS 56 and 64, ~80 KiB at 8 and 16). A half
// slab's padding rows are prepared as zeros and never stored
// (ttt_mlp_train_step.cuh).

namespace {

namespace ts = ttts;

template <int NS>
struct TrainSmem {
  static constexpr int kCS = ts::kSlab * NS;
  static constexpr int kTok = ts::tile_elems<ts::kF>(kCS), kWide = ts::tile_elems<ts::kF4>(kCS);
  __nv_bfloat16 xq[2][kTok], xk[2][kTok];  // the prepared ring (the targets go through the workspace)
  float eta[2][kCS];
  __nv_bfloat16 x2c[kWide], x2b[kWide], g1[kWide], w2s[ts::tile_elems<ts::kF>(ts::kF4)];
  float z2[kCS * ts::kLdZ];
  __nv_bfloat16 gz2[kTok], g2[kTok];
  float b1[ts::kF4];
  uint64_t full[2], empty[2];
};
static_assert(sizeof(TrainSmem<4>) <= 232448, "exceeds the 227 KB shared-memory opt-in");

struct TrainArgs {
  tttb::ScanArgs a;
  const float *ln_w, *ln_b, *W1, *b1, *W2, *b2;
  __nv_bfloat16* out;
  float *w1_ck, *b1_ck, *w2_ck, *b2_ck;
  float* work;  // per scan, the two stages of the LN-reconstruction targets [2][CS][F]
  int K;  // 0: no checkpoints (sampling)
};
template <int NS>
constexpr int kTrainWorkFloats = 2 * ts::kSlab * NS * ts::kF;

template <int CS>
__global__ void __launch_bounds__(ts::kThreads, 1) ttt_mlp_fwd_train_kernel(const TrainArgs A) {
  constexpr int NS = ts::slabs(CS), kCS = ts::kSlab * NS;  // kCS: the tiles' rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TrainSmem<NS>& S = *reinterpret_cast<TrainSmem<NS>*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / A.a.H, h = bh % A.a.H, NC = A.a.NC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&S.full[s], 128);
      hopper::mbar_init(&S.empty[s], ts::kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= ts::kWarps) {  // the producer warpgroup
    hopper::reg_dealloc<ts::kProducerRegs>();
    for (int n = 0; n < NC; ++n) {
      const int s = n & 1;
      if (n >= 2) hopper::mbar_wait(&S.empty[s], ((n >> 1) - 1) & 1);
      const ts::Prep p{S.xq[s], S.xk[s], A.work + ((size_t)bh * 2 + s) * kCS * ts::kF, S.eta[s], nullptr, nullptr,
                       nullptr};
      ts::prepare_rows<CS, kCS / 4>(p, A.a, A.ln_w, A.ln_b, b, h, n, warp - ts::kWarps, lane);
      hopper::mbar_arrive(&S.full[s]);
    }
    return;
  }
  hopper::reg_alloc<ts::kConsumerRegs>();
  constexpr int kState = ts::kF * ts::kF4;
  const int NG = A.K > 0 ? (NC + A.K - 1) / A.K : 0;
  ts::State st;
  ts::load_state(st, A.W1 + (size_t)h * kState, A.b1 + (size_t)h * ts::kF4, A.W2 + (size_t)h * kState,
                 A.b2 + (size_t)h * ts::kF, S.w2s, S.b1, warp, lane);
  const ts::Tiles T{S.x2c, S.x2b, S.w2s, S.z2, S.gz2, S.g2, S.g1, S.b1};
  const size_t HF = (size_t)A.a.H * ts::kF;
  for (int n = 0; n < NC; ++n) {
    const int s = n & 1;
    if (A.K > 0 && n % A.K == 0) {
      const size_t g = (size_t)bh * NG + n / A.K;
      ts::save_state(st, S.b1, A.w1_ck + g * kState, A.b1_ck + g * ts::kF4, A.w2_ck + g * kState, A.b2_ck + g * ts::kF,
                     warp, lane);
    }
    hopper::mbar_wait(&S.full[s], (n >> 1) & 1);
    const ts::Prep p{S.xq[s], S.xk[s], A.work + ((size_t)bh * 2 + s) * kCS * ts::kF, S.eta[s], nullptr, nullptr,
                     nullptr};
    ts::forward_step<CS, true>(st, p, T, A.ln_w + (size_t)h * ts::kF, A.ln_b + (size_t)h * ts::kF, A.out,
                               ((size_t)b * NC + n) * CS * HF + (size_t)h * ts::kF, HF, warp, lane);
    hopper::mbar_arrive(&S.empty[s]);
  }
}

}  // namespace

// Shared memory of the training kernel's instantiation for mini-batch cs (an error code, negative, for a CS it
// is not built for).
extern "C" int ttt_mlp_forward_train_smem_bytes(int cs) {
  int bytes = -static_cast<int>(cudaErrorInvalidValue);
  ts::with_slabs(cs, [&](auto c) { return bytes = (int)sizeof(TrainSmem<ts::slabs(decltype(c)::value)>); });
  return bytes;
}

// Floats of the training kernel's workspace a (batch, head) at mini-batch cs (negative for a CS it does not take).
extern "C" long long ttt_mlp_forward_train_workspace_floats(int cs) {
  long long floats = -1;
  ts::with_slabs(cs, [&](auto c) { return (int)(floats = kTrainWorkFloats<ts::slabs(decltype(c)::value)>); });
  return floats;
}

namespace {

template <int CS>
int launch_train(const TrainArgs& A, int B, int H, void* stream) {
  constexpr int kBytes = sizeof(TrainSmem<ts::slabs(CS)>);
  cudaError_t err =
      cudaFuncSetAttribute(ttt_mlp_fwd_train_kernel<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ttt_mlp_fwd_train_kernel<CS><<<B * H, ts::kThreads, kBytes, static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ttt_mlp_forward_train(const void* xq, const void* xk, const void* xv, const void* gate,
                                     const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                                     const void* W1, const void* b1, const void* W2, const void* b2, void* out,
                                     void* w1_ck, void* b1_ck, void* w2_ck, void* b2_ck, void* work, int B, int NC,
                                     int H, int CS, int K, float eta_scale, void* stream) {
  const TrainArgs A{{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                     static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                     static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin), NC, H, eta_scale},
                    static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
                    static_cast<const float*>(b1), static_cast<const float*>(W2), static_cast<const float*>(b2),
                    static_cast<__nv_bfloat16*>(out), static_cast<float*>(w1_ck), static_cast<float*>(b1_ck),
                    static_cast<float*>(w2_ck), static_cast<float*>(b2_ck), static_cast<float*>(work), K};
  return ts::with_slabs(CS, [&](auto c) { return launch_train<decltype(c)::value>(A, B, H, stream); });
}

// Shared memory of the kernel ttt_mlp_forward launches at mini-batch cs (an error code for a CS it does not take).
extern "C" int ttt_mlp_forward_smem_bytes(int cs) {
  return cs == 16 ? kSmemBytes : ttt_mlp_forward_train_smem_bytes(cs);
}

// K1, sampling (no checkpoints), by mini-batch: CS = 16 the sampling kernel, CS = 8, 24, 32, 40, 48, 56 and 64
// the training kernel with K = 0 and its LN targets in ``work`` (B H ttt_mlp_forward_train_workspace_floats(CS)
// floats; unused at CS = 16). These cases are the sampling mini-batches (ops/ttt_mlp_kernel.py:
// KERNEL_MINI_BATCHES).
extern "C" int ttt_mlp_forward(const void* xq, const void* xk, const void* xv, const void* gate,
                               const void* rope_cos, const void* rope_sin, const void* ln_w, const void* ln_b,
                               const void* W1, const void* b1, const void* W2, const void* b2, void* out, void* work,
                               int B, int NC, int H, int CS, float eta_scale, void* stream) {
  switch (CS) {
    case 16: {
      cudaError_t err =
          cudaFuncSetAttribute(ttt_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      const Args a{static_cast<const __nv_bfloat16*>(xq), static_cast<const __nv_bfloat16*>(xk),
                   static_cast<const __nv_bfloat16*>(xv), static_cast<const float*>(gate),
                   static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
                   static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), static_cast<const float*>(W1),
                   static_cast<const float*>(b1), static_cast<const float*>(W2), static_cast<const float*>(b2),
                   static_cast<__nv_bfloat16*>(out), NC, H, eta_scale};
      ttt_mlp_fwd_kernel<<<B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
      return static_cast<int>(cudaGetLastError());
    }
    case 8:
    case 24:
    case 32:
    case 40:
    case 48:
    case 56:
    case 64:
      return ttt_mlp_forward_train(xq, xk, xv, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, out, nullptr,
                                   nullptr, nullptr, nullptr, work, B, NC, H, CS, 0, eta_scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
