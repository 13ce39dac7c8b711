// ssd_scan_bwd.cu -- the backward of the Mamba2 SSD intra-chunk step
// (kernel C's gradient).
//
// Replaces: nothing of the JAX package runs it as a kernel.  Its Pallas
// call src/repro/kernels/ssd_scan.py::ssd_intra_chunk (:58) has no VJP;
// the JAX package trains by XLA's autodiff of its plain
// models/ssm.py::ssd_chunked.  This kernel computes that gradient for the
// port's kernel C (ssd_scan.cu), so that no plain version runs on the card.
//
// What it computes, per cell g (one batch row, chunk and head; cells
// ordered (batch, chunk, head), b and c shared by the `heads` cells of a
// (batch, chunk)), given the cotangents gy (L x P), gS (N x P) and ga of
// y, S and a, with CB = C Bt, M_ij = exp(cum_i - cum_j) for i >= j (0
// above), W = CB o M, d = exp(cum[L-1] - cum):
//   dX   = Wt gy + (B o d) gS
//   dW   = gy Xt,  dCB = dW o M,  Q = dW o W
//   dC   = (sum over heads of dCB) B
//   dB   = (sum over heads of dCB)t C + sum over heads of d o (X gSt)
//   dcum = rowsum(Q) - colsum(Q) - d o r,  r = rowsum(B o (X gSt)),
//          plus sum(d o r) + ga exp(cum[L-1]) at position L-1
// All f32; bf16 b and c are widened exactly, and their gradients leave in
// f32 (the wrapper rounds them to bf16, as autograd of the widening does).
//
// What bounds it on an H100: at the Mamba2-370M federated round's shape
// (8 (batch, chunk) groups x 32 heads, L = 256, P = 64, N = 128) the
// function needs about 4.5 GFLOP on the causal triangle (CB once per
// (batch, chunk); dW and Wt gy per cell; the two N x P products per cell;
// dC and dB once per (batch, chunk)) and moves about 63 MB.  On the tensor
// cores with split TF32 (three products for each f32 one) that is 27 us at
// 495 TFLOP/s; the bytes take 19 us at 3.35 TB/s.  At ssm_lm's local step
// (L = 8, P = 16, N = 8, 4 heads) the whole call is 0.5 MB and 1 MFLOP:
// nothing on the card bounds it, the host's call does.
//
// Two routes, picked by shape in kernels/ssd_scan.py::bwd_route:
//
// Route 1, full chunks: split-TF32 wgmma (ssd_tf32.cuh, as the forward),
// three launches (four with several head groups), no float atomics (the
// same bits run to run).
// * Pass 0 (ssd_bwd_cb), one CTA per (batch, chunk, pair of 64-row tiles
//   it >= jt): C Bt_ji, to a workspace in pass 1's accumulator order.
// * Pass 1 (ssd_bwd_cols), one CTA per (batch, chunk, 64-column tile j,
//   head group), two warpgroups.  It works on the transposed scores, rows
//   j and columns i, so that Wt leaves the accumulators as the register A
//   operand of the product that sums over i.  Head by head, a sequence of
//   steps, each with one 64 x 64 tile of gy (rows i) or of gS (rows n) in
//   shared memory twice, natural and transposed:
//     gy tile i:  dWt_ji = X_j gy_it (K = P), then on the accumulators
//                 M, Wt, Q, the head group's dCBt (summed in shared
//                 memory), the row and column sums of Q; then
//                 dX_j += Wt_ji gy_i (K = i, A from registers);
//     gS chunk:   (X gSt)_j (K = P), then r and the head group's sum of
//                 d o (X gSt) for dB; then dX_j += (B o d)_j gS (K = n).
//   Each warpgroup takes one 32-column half of every tile, so the heads'
//   sums stay thread-private; its share of dX is added to the other's in
//   a fixed order when the head is done.  The next step's tile is copied
//   (cp.async) while this step's products run.  Head groups exist to
//   fill 132 SMs when (batch, chunk) groups are few.
// * Where there are several head groups, ssd_bwd_sum adds their dCB and
//   dB terms in the groups' order, over the whole card.
// * Pass 2 (ssd_bwd_rows), one CTA per (batch, chunk, 64-row tile, dC or
//   dB, 64 columns of n): dC_i = dCB_i B (K = j) or dB_j = dCBt_j C
//   (K = i), plus the d o (X gSt) term for dB; the dC CTAs also add up
//   dcum.
// * Every product is hi*hi + lo*hi + hi*lo into two accumulators, fresh
//   for each step, added to the running sum in f32 with round to nearest
//   (ssd_scan.cu's header says why).  Tiles above the diagonal are
//   skipped; the mask sits in the exponent (a term above the diagonal is
//   zero before its exp).
//
// Route 2, small chunks (ssd_bwd_small): one launch, no workspace.  One CTA
// of 256 threads per (batch, chunk) owns all its heads, so dB and dC are
// summed over heads inside it; f32 FMAs on shared memory sized to the
// launch's (L, P, N) and to a batch of heads run at once (all 4 at
// ssm_lm's shape, in 12 KB: several CTAs share an SM, and the 80 (batch,
// chunk) groups of a step run in one wave).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tf32.cuh"

namespace {

constexpr int kMaxL = 256, kMaxP = 64;
constexpr int kOp = kTile * kTile;           // one part of a 64 x 64 operand
constexpr int kGsT = 16 * 16 + 4;            // its group stride, transposed
constexpr int kOpT = (kTile / 4) * kGsT;     // one part of it, transposed
constexpr int kOpBig = kTile * kMaxN;        // one part of a 64 x 128 one
constexpr int kSmemMax = 232448;             // shared memory a CTA can have
constexpr int kSmallThreads = 256;

// pass 1's shared memory, in floats
constexpr int kOffXj = 0;                    // X_j, hi and lo
constexpr int kOffGn = kOffXj + 2 * kOp;     // 2 buffers of the step's tile,
constexpr int kOffGt = kOffGn + 4 * kOp;     // natural and transposed
constexpr int kOffRaw = kOffGt + 4 * kOpT;   // 2 buffers of tiles, raw
constexpr int kOffCum = kOffRaw + 2 * kOp;   // cum of the cell
constexpr int kOffRed = kOffCum + kMaxL;     // reductions
constexpr int kSmem1 = kOffRed + 2 * 2 * 4 * 32 + 2 * 2 * 64 + 4;
constexpr int kSmem1Bytes = kSmem1 * (int)sizeof(float);
// pass 2's: its A and B operands
constexpr int kSmem2Bytes = 4 * kOpT * (int)sizeof(float);

static_assert(kSmem1Bytes <= kSmemMax, "pass 1 must fit one SM");

struct Args {
  const float* xb;
  const void* b;
  const void* c;
  const float* cum;
  const float* gy;
  const float* gs;
  const float* ga;
  int G, heads, L, P, N;
  int per, groups, gb, tiles, chunks, Lp, Np;   // route 1's plan
  float* dx;
  float* db;
  float* dc;
  float* dcum;
  float* ws_dcb;   // (groups, gb, Lp, Lp): each head group's dCB at [j][i]
  float* ws_db;    // (groups, gb, Lp, Np): its sum of d o (X gSt)
  float* ws_row;   // (G, tiles, Lp): rowsum(Q) over each column tile
  float* ws_col;   // (G, Lp): -colsum(Q) - d r
  float* ws_dr;    // (G, tiles): sum of d r over each column tile
  float* ws_cb;    // (gb, tiles, tiles, 64 x 64): C Bt of (jt, it <= jt)
};

// item i of a 64 x 64 tile in 4-value pieces (r, q), 8 threads per core
// matrix; 4 items per thread
constexpr int kTileItems = kTile * (kTile / 4) / kThreads;
__device__ __forceinline__ void tile_item(int i, int& r, int& q) {
  r = (i & 7) + (i >> 7) * 8;
  q = (i >> 3) & 15;
}

// rows [row0, row0 + 64) of a (rows, W) f32 matrix (W <= 64) to `raw` in
// the layout of a 64 x 64 operand (zero past `rows` and W)
__device__ void copy_tile(const float* __restrict__ src, int row0, int rows,
                          int W, float* raw) {
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    int r, q;
    tile_item(threadIdx.x + u * kThreads, r, q);
    const bool ok = row0 + r < rows && 4 * q < W;
    cp_async<16>(raw + op_index(kTile * 4, r, 4 * q),
                 src + (ok ? (long long)(row0 + r) * W + 4 * q : 0), ok);
  }
}

// the raw values copy_tile left at `raw`, split into the hi and lo halves
// of a 64 x 64 operand in the same layout (each thread writes where it
// read, so `lo` may be `raw`)
__device__ void split_tile(const float* raw, float* hi, float* lo) {
  float4 v[kTileItems];
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    int r, q;
    tile_item(threadIdx.x + u * kThreads, r, q);
    v[u] = *reinterpret_cast<const float4*>(raw + op_index(kTile * 4, r, 4 * q));
  }
#pragma unroll
  for (int u = 0; u < kTileItems; ++u) {
    int r, q;
    tile_item(threadIdx.x + u * kThreads, r, q);
    put4(hi, lo, op_index(kTile * 4, r, 4 * q), v[u]);
  }
}

// 4 values of row-major b or c at element e (a multiple of 4), widened
template <bool kBf16>
__device__ __forceinline__ float4 ld4(const void* p, long long e) {
  if (kBf16) {
    return widen4(*reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned short*>(p) + e));
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) +
                                          e);
}

// b at (row, n) and (row, n + 1), n even, widened; zero unless `ok`
template <bool kBf16>
__device__ __forceinline__ float2 ld2(const void* b, long long e, bool ok) {
  if (!ok) return make_float2(0.f, 0.f);
  if (kBf16) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const unsigned short*>(b) + e);
    return make_float2(__uint_as_float(v << 16),
                       __uint_as_float(v & 0xffff0000u));
  }
  return *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(b) +
                                          e);
}

// Pass 1's warpgroups run apart between heads: each copies and splits
// its own half of every tile (the rows, or the K columns, it reads) and
// waits only for its own 128 threads (named barrier 1 + w), so that one's
// products run on the tensor cores while the other splits or works on
// its accumulators.
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}
// the copies of a step's tile have landed, this thread's and then its
// warpgroup's; with `later`, the one step's copies started after them may
// still be in flight
__device__ __forceinline__ void wg_tile_landed(int wg, bool later) {
  if (later) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  wg_sync(wg);
}
// this warpgroup's shared-memory stores visible to the MMA unit, and its
// threads past every earlier read
__device__ __forceinline__ void wg_publish(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
}

// item i (of 512) of warpgroup w's half of a 64 x 64 tile: rows [32w,
// 32w + 32) in 4-value pieces (r, q), 4 items a thread
__device__ __forceinline__ void half_item(int wg, int i, int& r, int& q) {
  r = 32 * wg + (i & 7) + (i >> 7) * 8;
  q = (i >> 3) & 15;
}

// warpgroup w's rows [32w, 32w + 32) of the tile at row0 of a (rows, W)
// f32 matrix (W <= 64), to `raw` as copy_tile lays it out
__device__ void copy_half(const float* __restrict__ src, int row0, int rows,
                          int W, float* raw, int wg) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int r, q;
    half_item(wg, (threadIdx.x & 127) + u * 128, r, q);
    const bool ok = row0 + r < rows && 4 * q < W;
    cp_async<16>(raw + op_index(kTile * 4, r, 4 * q),
                 src + (ok ? (long long)(row0 + r) * W + 4 * q : 0), ok);
  }
}

// warpgroup w's half of the raw tile, split: its rows of the natural
// operand (P1's B, rows i or n) and its K columns of the transposed one
// (P2's B, K permuted as the register A operand holds it: slot t of an
// 8-column step is column 2t, slot t + 4 column 2t + 1)
__device__ void split_half(const float* raw, float* nhi, float* nlo,
                           float* thi, float* tlo, int wg) {
  const int t = threadIdx.x & 127;
  float4 v[4], x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int r, q;
    half_item(wg, t + u * 128, r, q);
    v[u] = *reinterpret_cast<const float4*>(raw + op_index(kTile * 4, r, 4 * q));
  }
  const int kb = t & 7, m = t >> 3;   // 4 positions, quad of P
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int l = 32 * wg + 8 * (kb >> 1) + (kb & 1) + 2 * e;
    x[e] = *reinterpret_cast<const float4*>(raw + op_index(kTile * 4, l, 4 * m));
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    int r, q;
    half_item(wg, t + u * 128, r, q);
    put4(nhi, nlo, op_index(kTile * 4, r, 4 * q), v[u]);
  }
  const int k0 = 32 * wg + 4 * kb;
  put4(thi, tlo, op_index(kGsT, 4 * m, k0),
       make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
  put4(thi, tlo, op_index(kGsT, 4 * m + 1, k0),
       make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
  put4(thi, tlo, op_index(kGsT, 4 * m + 2, k0),
       make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
  put4(thi, tlo, op_index(kGsT, 4 * m + 3, k0),
       make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
}

// Warpgroup w's half of the raw tile of step k of a pass-1 CTA, to raw
// buffer k & 1, as one group of copies: step s of its head hd (k = hd *
// nsteps + s) is the gy rows of row tile jt + s (s < nw) or the gS rows of
// chunk s - nw
__device__ void copy_step(const Args& A, int gbi, int h0, int jt, int nw,
                          int nsteps, int k, float* raw, int wg) {
  const int hd = k / nsteps, s = k - hd * nsteps;
  const long long g = (long long)gbi * A.heads + h0 + hd;
  float* dst = raw + (k & 1) * kOp;
  if (s < nw) {
    copy_half(A.gy + g * A.L * A.P, (jt + s) * kTile, A.L, A.P, dst, wg);
  } else {
    copy_half(A.gs + g * A.N * A.P, (s - nw) * kTile, A.N, A.P, dst, wg);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Pass 0: C Bt_ji = B_j C_it for one (batch, chunk) and one pair of
// tiles it >= jt (both natural operands, K = n), to the workspace in
// pass 1's accumulator order (warpgroup w columns [32w, 32w + 32)).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cb(const Args A) {
  extern __shared__ __align__(128) float sm[];
  float* b_hi = sm;
  float* b_lo = b_hi + kOpBig;
  float* c_hi = b_lo + kOpBig;
  float* c_lo = c_hi + kOpBig;
  // bf16 rows of b and of c on their way in
  unsigned short* stage = reinterpret_cast<unsigned short*>(c_lo + kOpBig);
  unsigned short* stage_c = stage + kTile * kMaxN;
  const int T = A.tiles, npair = T * (T + 1) / 2;
  const int gbi = blockIdx.x / npair;
  int pair = blockIdx.x - gbi * npair, jt = 0;
  while (pair >= T - jt) pair -= T - jt++;
  const int it = jt + pair;
  const int L = A.L, N = A.N;
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const long long bc0 = (long long)gbi * L * N;
  copy_rows<kBf16>(A.b, bc0, jt * kTile, L, N, b_lo, stage);
  copy_rows<kBf16>(A.c, bc0, it * kTile, L, N, c_lo, stage_c);
  cp_async_wait();
  split_rows<kBf16>(b_hi, b_lo, stage);
  split_rows<kBf16>(c_hi, c_lo, stage_c);
  publish();
  float hh[16], cr[16];
  mma_fence();
#pragma unroll
  for (int k = 0; k < kMaxN; k += 8) {
    const int o = (k >> 2) * (kTile * 4);
    const uint64_t bh = op_desc(b_hi + o, kTile * 4);
    const uint64_t bl = op_desc(b_lo + o, kTile * 4);
    const uint64_t ch = op_desc(c_hi + o + 128 * wg, kTile * 4);
    const uint64_t cl = op_desc(c_lo + o + 128 * wg, kTile * 4);
    mma_ss32(hh, bh, ch, k > 0);
    mma_ss32(cr, bl, ch, k > 0);
    mma_ss32(cr, bh, cl, 1);
  }
  mma_wait();
  float* o = A.ws_cb + (((long long)gbi * T + jt) * T + it) * kOp +
             wg * 16 * 128 + t128;
#pragma unroll
  for (int v = 0; v < 16; ++v) o[v * 128] = hh[v] + cr[v];
}

// Pass 1: the column tile jt of (batch, chunk) gbi for head group hg.
// Warpgroup w owns columns [32w, 32w + 32) of every row tile and chunk; a
// thread's accumulator values sit at rows ra, rb (j - j0) and columns
// 8q + 2tq (+1) of its half.  The step's tile lives in one of two
// buffers: while the first product of a step runs on the tensor cores,
// the threads split the next step's tile into the other.  The head
// group's dCBt and d o (X gSt) accumulate in the workspace itself, each
// value read back and written by the one thread that owns it.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_cols(const Args A) {
  extern __shared__ __align__(128) float sm[];
  float* xj_hi = sm + kOffXj;
  float* xj_lo = xj_hi + kOp;
  float* raw = sm + kOffRaw;
  float* cum_s = sm + kOffCum;
  float* rowred = sm + kOffRed;      // [2][warpgroup][warp][32 columns]
  float* rowsum = rowred + 512;      // [warpgroup][colsum(Q), r][64 rows]
  float* drs = rowsum + 256;         // [2]
  // buffer b of the step's tile: natural (hi, lo), transposed (hi, lo);
  // warpgroup w splits and reads rows [32w, 32w + 32) of the natural one
  // and K columns [32w, 32w + 32) of the transposed one
  auto gn_hi = [&](int b) { return sm + kOffGn + b * 2 * kOp; };
  auto gt_hi = [&](int b) { return sm + kOffGt + b * 2 * kOpT; };

  const int L = A.L, P = A.P, N = A.N, Lp = A.Lp;
  const int per_tile = A.gb * A.groups;
  const int jt = blockIdx.x / per_tile;          // longest tiles first
  const int rem = blockIdx.x - jt * per_tile;
  const int gbi = rem / A.groups, hg = rem - gbi * A.groups;
  const int j0 = jt * kTile, nw = A.tiles - jt, nsteps = nw + A.chunks;
  const int h0 = hg * A.per, total = A.per * nsteps;
  const int tid = threadIdx.x, lane = tid & 31, t128 = tid & 127;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq, rb = ra + 8;
  const long long bc0 = (long long)gbi * L * N;
  // this thread's C Bt values (pass 0): row tile it at + it * kOp, value
  // v at + v * 128
  const float* cbw = A.ws_cb + ((long long)gbi * A.tiles + jt) * A.tiles *
                     kOp + wg * 16 * 128 + t128;
  // this thread's dCBt pairs (row tile it at + it * kTile, value pair
  // 4q + 2h2 at + (h2 ? rb : ra) * Lp + 8q) and d o (X gSt) pairs (chunk
  // c at + c * kTile, the same rows and columns with Np)
  const long long grp = (long long)hg * A.gb + gbi;
  float* dcbw = A.ws_dcb + (grp * Lp + j0) * Lp + 32 * wg + 2 * tq;
  float* dbxw = A.ws_db + (grp * Lp + j0) * A.Np + 32 * wg + 2 * tq;

  // the first two steps' tiles, the first head's X_j and cum
  copy_step(A, gbi, h0, jt, nw, nsteps, 0, raw, wg);
  if (total > 1) copy_step(A, gbi, h0, jt, nw, nsteps, 1, raw, wg);
  {
    const long long g = (long long)gbi * A.heads + h0;
    copy_tile(A.xb + g * L * P, j0, L, P, xj_lo);
    for (int i = tid; i < kMaxL; i += kThreads) {
      cp_async<4>(cum_s + i, A.cum + g * L + (i < L ? i : 0), i < L);
    }
  }
  cp_async_wait();
  split_tile(xj_lo, xj_hi, xj_lo);
  split_half(raw, gn_hi(0), gn_hi(0) + kOp, gt_hi(0), gt_hi(0) + kOpT, wg);
  publish();                         // and every thread is done with raw

  for (int hd = 0; hd < A.per; ++hd) {
    const long long g = (long long)gbi * A.heads + h0 + hd;
    if (hd > 0) {                    // its X_j and cum, copied at the last
      cp_async_wait();               // head's end
      split_tile(xj_lo, xj_hi, xj_lo);
      publish();
    }
    const float clast = cum_s[L - 1];
    const bool va = j0 + ra < L, vb = j0 + rb < L;
    const float cja = cum_s[j0 + ra], cjb = cum_s[j0 + rb];
    const float da = va ? expf(clast - cja) : 0.f;
    const float db = vb ? expf(clast - cjb) : 0.f;
    float dx[32];
    zero(dx);
    float cqa = 0.f, cqb = 0.f, rra = 0.f, rrb = 0.f;
    int b = 0;

    for (int s = 0; s < nsteps; ++s) {
      const int k = hd * nsteps + s;
      b = k & 1;
      const bool wt = s < nw;
      const int it = jt + s, c = s - nw;
      float* gnh = gn_hi(b);
      float* gth = gt_hi(b);
      // the tile of step k + 2, to the raw buffer step k's tile left
      if (k + 2 < total) {
        copy_step(A, gbi, h0, jt, nw, nsteps, k + 2, raw, wg);
      }

      // X_j times the tile's rows (K = P): dWt_ji, or (X gSt)_jn; on the
      // tensor cores while the threads load what the epilogue reads and
      // split the next step's tile.  (A descriptor's address field counts
      // 16 bytes: the next 8 columns of K are (8 / 4) * 256 floats, 128
      // units, on.)
      float hh[16], cr[16];
      const uint64_t dxh = op_desc(xj_hi, kTile * 4);
      const uint64_t dxl = op_desc(xj_lo, kTile * 4);
      const uint64_t dgh = op_desc(gnh + 128 * wg, kTile * 4);
      const uint64_t dgl = op_desc(gnh + kOp + 128 * wg, kTile * 4);
      mma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 8) {
        const uint64_t o = (kk >> 3) * 128;
        mma_ss32(hh, dxh + o, dgh + o, kk > 0);
        mma_ss32(cr, dxl + o, dgh + o, kk > 0);
        mma_ss32(cr, dxh + o, dgl + o, 1);
      }
      mma_commit();
      // what the epilogue reads: C Bt, or B; and the head group's sums
      // so far
      float cbv[16];
      float2 bva[4], bvb[4], acc2[8];
      if (wt) {
#pragma unroll
        for (int v = 0; v < 16; ++v) cbv[v] = cbw[it * kOp + v * 128];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = kTile * c + 32 * wg + 8 * q + 2 * tq;
          bva[q] = ld2<kBf16>(A.b, bc0 + (long long)(j0 + ra) * N + n,
                              va && n < N);
          bvb[q] = ld2<kBf16>(A.b, bc0 + (long long)(j0 + rb) * N + n,
                              vb && n < N);
        }
      }
      float* sums = wt ? dcbw + it * kTile : dbxw + c * kTile;
      const int pitch = wt ? Lp : A.Np;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int q = x >> 1, row = (x & 1) ? rb : ra;
        acc2[x] = hd == 0 ? make_float2(0.f, 0.f)
                          : *reinterpret_cast<const float2*>(
                                sums + (long long)row * pitch + 8 * q);
      }
      if (k + 1 < total) {
        wg_tile_landed(wg, k + 2 < total);   // the next step's tile
        split_half(raw + ((k + 1) & 1) * kOp, gn_hi(b ^ 1),
                   gn_hi(b ^ 1) + kOp, gt_hi(b ^ 1), gt_hi(b ^ 1) + kOpT, wg);
      }
      mma_wait_all();

      // av: the A operand of this step's share of dX, Wt or B o d
      float av[16];
      if (wt) {
        const int i0 = it * kTile + 32 * wg;
        // below the diagonal tile and inside the chunk, nothing is masked
        const bool inside = it > jt && it * kTile + kTile <= L;
        float rp[8];                 // Q's sums over this thread's rows
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * q + 2 * tq + e;
            const float ci = cum_s[i];
            float part = 0.f;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int v = 4 * q + 2 * h2 + e;
              const int j = j0 + (h2 ? rb : ra);
              const bool on = inside || (i < L && j <= i);
              // the mask before the exp; where on, cum_i - cum_j <= 0 and
              // the fast exp is within about 2e-7 of the value, below
              // split TF32's error
              const float m = on ? __expf(ci - (h2 ? cjb : cja)) : 0.f;
              const float dw = hh[v] + cr[v];
              const float w = on ? cbv[v] * m : 0.f;
              const float qv = dw * w;
              float& sum = e ? acc2[2 * q + h2].y : acc2[2 * q + h2].x;
              sum += dw * m;
              if (h2) {
                cqb += qv;
              } else {
                cqa += qv;
              }
              part += qv;
              av[v] = w;
            }
            rp[2 * q + e] = part;
          }
        }
        // rowsum(Q) of the tile's columns over this CTA's rows: the 8 gq
        // lanes here, the 4 warps after the step's barrier, W steps
        // alternating between two buffers
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          rp[x] += __shfl_xor_sync(0xffffffffu, rp[x], 4);
          rp[x] += __shfl_xor_sync(0xffffffffu, rp[x], 8);
          rp[x] += __shfl_xor_sync(0xffffffffu, rp[x], 16);
        }
        float* red = rowred + (it & 1) * 256;
        if (gq == 0) {
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            red[(wg * 4 + warp) * 32 + 8 * (x >> 1) + 2 * tq + (x & 1)] =
                rp[x];
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const float2 bv = h2 ? bvb[q] : bva[q];
            const float dj = h2 ? db : da;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int v = 4 * q + 2 * h2 + e;
              const float bval = e ? bv.y : bv.x;
              const float xg = hh[v] + cr[v];
              if (h2) {
                rrb += bval * xg;
              } else {
                rra += bval * xg;
              }
              float& sum = e ? acc2[2 * q + h2].y : acc2[2 * q + h2].x;
              sum += dj * xg;
              av[v] = bval * dj;
            }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int q = x >> 1, row = (x & 1) ? rb : ra;
        *reinterpret_cast<float2*>(sums + (long long)row * pitch + 8 * q) =
            acc2[x];
      }

      // this step's share of dX (K = its 32 columns of the tile), hi*hi
      // and corrections apart, folded into dx in f32.  Register A: (row
      // ra, slot tq), (rb, tq), (ra, tq + 4), (rb, tq + 4), slot t holding
      // column 2t and slot t + 4 column 2t + 1, as the transposed tile
      // stores them
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        split(av[4 * q], ahi[q][0], alo[q][0]);
        split(av[4 * q + 2], ahi[q][1], alo[q][1]);
        split(av[4 * q + 1], ahi[q][2], alo[q][2]);
        split(av[4 * q + 3], ahi[q][3], alo[q][3]);
      }
      float th[32], tc[32];
      const uint64_t dth = op_desc(gth + 8 * wg * kGsT, kGsT);
      const uint64_t dtl = op_desc(gth + kOpT + 8 * wg * kGsT, kGsT);
      mma_fence();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t o = 2 * q * (kGsT / 4);   // the next 8 columns of K
        mma_rs(th, ahi[q], dth + o, q > 0);
        mma_rs(tc, alo[q], dth + o, q > 0);
        mma_rs(tc, ahi[q], dtl + o, 1);
      }
      mma_wait();
      fold(dx, th, tc);
      wg_publish(wg);                // its half of the next tile's split,
                                     // and its reads of raw and buffer b
      if (wt && t128 < 32) {         // rowsum(Q) of its 32 columns
        const float* red = rowred + (it & 1) * 256 + wg * 128 + t128;
        A.ws_row[(g * A.tiles + jt) * Lp + it * kTile + 32 * wg + t128] =
            red[0] + red[32] + red[64] + red[96];
      }
    }

    // the head is done: dX of the two warpgroups, added in a fixed order;
    // colsum(Q) and d r of each row over both halves
    __syncthreads();                 // both warpgroups are done with smem
    float* xch = gn_hi(b);           // warpgroup 1's dx: [32][128]
    if (wg == 1) {
#pragma unroll
      for (int v = 0; v < 32; ++v) xch[v * 128 + t128] = dx[v];
    }
    cqa += __shfl_xor_sync(0xffffffffu, cqa, 1);
    cqa += __shfl_xor_sync(0xffffffffu, cqa, 2);
    cqb += __shfl_xor_sync(0xffffffffu, cqb, 1);
    cqb += __shfl_xor_sync(0xffffffffu, cqb, 2);
    rra += __shfl_xor_sync(0xffffffffu, rra, 1);
    rra += __shfl_xor_sync(0xffffffffu, rra, 2);
    rrb += __shfl_xor_sync(0xffffffffu, rrb, 1);
    rrb += __shfl_xor_sync(0xffffffffu, rrb, 2);
    if (tq == 0) {
      rowsum[(2 * wg) * 64 + ra] = cqa;
      rowsum[(2 * wg) * 64 + rb] = cqb;
      rowsum[(2 * wg + 1) * 64 + ra] = rra;
      rowsum[(2 * wg + 1) * 64 + rb] = rrb;
    }
    __syncthreads();
    if (wg == 0) {
      float* dxg = A.dx + g * L * P;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = 8 * q + 2 * tq;
        if (p >= P) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + (e ? rb : ra);
          const int v = 4 * q + 2 * e;
          if (j < L) {
            *reinterpret_cast<float2*>(dxg + (long long)j * P + p) =
                make_float2(dx[v] + xch[v * 128 + t128],
                            dx[v + 1] + xch[(v + 1) * 128 + t128]);
          }
        }
      }
    }
    if (tid < 64) {
      const int j = j0 + tid;
      const float cq = rowsum[tid] + rowsum[128 + tid];
      const float r = rowsum[64 + tid] + rowsum[192 + tid];
      float dr = j < L ? expf(clast - cum_s[j]) * r : 0.f;
      if (j < L) A.ws_col[g * Lp + j] = -cq - dr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        dr += __shfl_xor_sync(0xffffffffu, dr, o);
      }
      if (lane == 0) drs[tid >> 5] = dr;
    }
    __syncthreads();
    if (tid == 0) A.ws_dr[g * A.tiles + jt] = drs[0] + drs[1];
    if (hd + 1 < A.per) {            // the next head's X_j and cum
      const long long g1 = g + 1;
      copy_tile(A.xb + g1 * L * P, j0, L, P, xj_lo);
      for (int i = tid; i < kMaxL; i += kThreads) {
        cp_async<4>(cum_s + i, A.cum + g1 * L + (i < L ? i : 0), i < L);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }
}

// Between the passes, where there are several head groups: their dCB
// blocks (it >= jt) and dB terms summed in the groups' order into group
// 0's, in place; one thread a float4, four groups' loads in flight.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum(const Args A) {
  const int T = A.tiles, Lp = A.Lp, npair = T * (T + 1) / 2;
  const long long nd = (long long)A.gb * npair * (kOp / 4);
  const long long total = nd + (long long)A.gb * Lp * A.Np / 4;
  const long long dplane = (long long)A.gb * Lp * Lp;
  const long long bplane = (long long)A.gb * Lp * A.Np;
  for (long long f = (long long)blockIdx.x * kThreads + threadIdx.x;
       f < total; f += (long long)gridDim.x * kThreads) {
    float* p;
    long long plane;
    if (f < nd) {
      const int e = (int)(f % (kOp / 4));
      int pair = (int)((f / (kOp / 4)) % npair), jt = 0;
      const long long gbi = f / (kOp / 4) / npair;
      while (pair >= T - jt) pair -= T - jt++;
      const int r = e >> 4, q = e & 15;
      p = A.ws_dcb + (gbi * Lp + jt * kTile + r) * Lp + (jt + pair) * kTile +
          4 * q;
      plane = dplane;
    } else {
      p = A.ws_db + 4 * (f - nd);
      plane = bplane;
    }
    float4 s = *reinterpret_cast<const float4*>(p);
    int hg = 1;
    for (; hg + 4 <= A.groups; hg += 4) {
      float4 v[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        v[a] = *reinterpret_cast<const float4*>(p + (hg + a) * plane);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        s = make_float4(s.x + v[a].x, s.y + v[a].y, s.z + v[a].z,
                        s.w + v[a].w);
      }
    }
    for (; hg < A.groups; ++hg) {
      const float4 v = *reinterpret_cast<const float4*>(p + hg * plane);
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    *reinterpret_cast<float4*>(p) = s;
  }
}

// Pass 2: the row tile t of (batch, chunk) gbi, columns [64 nh, 64 nh +
// 64) of dC (rows i, K = j <= i) or of dB (rows j, K = i >= j), from dCB
// summed over the head groups (group 0's place); warpgroup w forms
// columns [32w, 32w + 32).  A chunk of K is 64 wide: its dCB block and
// rows of b or c come to registers while the last chunk's products run,
// then split into the operands.  The dC CTAs of nh = 0 add up dcum of
// the tile's rows.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows(const Args A) {
  extern __shared__ __align__(128) float sm[];
  float* a_hi = sm;
  float* a_lo = a_hi + kOpT;
  float* b_hi = a_lo + kOpT;
  float* b_lo = b_hi + kOpT;

  const int L = A.L, N = A.N, Lp = A.Lp, T = A.tiles;
  const int per_rank = A.gb * A.chunks * 2;
  const int rank = blockIdx.x / per_rank;        // longest first
  int rem = blockIdx.x - rank * per_rank;
  const bool is_dc = (rem & 1) == 0;
  rem >>= 1;
  const int gbi = rem / A.chunks, nh = rem - gbi * A.chunks;
  const int t = is_dc ? T - 1 - rank : rank;
  const int r0 = t * kTile, n0 = nh * kTile;
  const long long bc0 = (long long)gbi * L * N;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq, rb = ra + 8;
  // this thread's piece of a chunk: for the transposed operands (dC's A,
  // both B) 4 positions of quad m (split_t's item), for dB's natural A
  // its 4 tile items
  const int kb = tid & 15, m = tid >> 4;
  const void* bc = is_dc ? A.b : A.c;
  const float* dcb = A.ws_dcb + (long long)gbi * Lp * Lp;

  float4 av[4], bv[4];
  auto load = [&](int kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = 4 * kb + e, row = kc * kTile + l, n = n0 + 4 * m;
      bv[e] = row < L && n < N ? ld4<kBf16>(bc, bc0 + (long long)row * N + n)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      if (is_dc) {                   // dCB rows i of tile t, K = j
        av[e] = *reinterpret_cast<const float4*>(
            dcb + (long long)(kc * kTile + l) * Lp + r0 + 4 * m);
      } else {                       // dCBt rows j of tile t, K = i
        int r, q;
        tile_item(tid + e * kThreads, r, q);
        av[e] = *reinterpret_cast<const float4*>(
            dcb + (long long)(r0 + r) * Lp + kc * kTile + 4 * q);
      }
    }
  };
  // 4 positions x 4 columns, transposed into rows 4m .. 4m + 3 of an
  // operand of group stride kGsT at K columns 4kb .. 4kb + 3
  auto put_t = [&](const float4 (&x)[4], float* hi, float* lo) {
    put4(hi, lo, op_index(kGsT, 4 * m, 4 * kb),
         make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
    put4(hi, lo, op_index(kGsT, 4 * m + 1, 4 * kb),
         make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
    put4(hi, lo, op_index(kGsT, 4 * m + 2, 4 * kb),
         make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
    put4(hi, lo, op_index(kGsT, 4 * m + 3, 4 * kb),
         make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
  };

  float acc[16];
#pragma unroll
  for (int v = 0; v < 16; ++v) acc[v] = 0.f;
  const int first = is_dc ? 0 : t, last = is_dc ? t : T - 1;
  // A: dCB rows i (transposed) for dC, dCBt rows j (natural) for dB
  const int ags = is_dc ? kGsT : kTile * 4;
  const uint64_t dah = op_desc(a_hi, ags), dal = op_desc(a_lo, ags);
  const uint64_t dbh = op_desc(b_hi + 128 * wg, kGsT);
  const uint64_t dbl = op_desc(b_lo + 128 * wg, kGsT);
  load(first);
  for (int kc = first; kc <= last; ++kc) {
    __syncthreads();                 // the last chunk's products are done
    put_t(bv, b_hi, b_lo);
    if (is_dc) {
      put_t(av, a_hi, a_lo);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, q;
        tile_item(tid + e * kThreads, r, q);
        put4(a_hi, a_lo, op_index(kTile * 4, r, 4 * q), av[e]);
      }
    }
    publish();
    float hh[16], cr[16];
    mma_fence();
#pragma unroll
    for (int k = 0; k < kTile; k += 8) {
      // the next 8 columns of K, in the descriptors' 16-byte units
      const uint64_t oa = (k >> 2) * (ags / 4), ob = (k >> 2) * (kGsT / 4);
      mma_ss32(hh, dah + oa, dbh + ob, k > 0);
      mma_ss32(cr, dal + oa, dbh + ob, k > 0);
      mma_ss32(cr, dah + oa, dbl + ob, 1);
    }
    mma_commit();
    if (kc < last) load(kc + 1);
    mma_wait_all();
#pragma unroll
    for (int v = 0; v < 16; ++v) acc[v] += hh[v] + cr[v];
  }

  float* out = is_dc ? A.dc : A.db;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + 32 * wg + 8 * q + 2 * tq;
    if (n >= N) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + (e ? rb : ra);
      if (row >= L) continue;
      float2 v = make_float2(acc[4 * q + 2 * e], acc[4 * q + 2 * e + 1]);
      if (!is_dc) {                  // the heads' d o (X gSt)
        const float2 s = *reinterpret_cast<const float2*>(
            A.ws_db + ((long long)gbi * Lp + row) * A.Np + n);
        v = make_float2(v.x + s.x, v.y + s.y);
      }
      *reinterpret_cast<float2*>(out + bc0 + (long long)row * N + n) = v;
    }
  }
  if (is_dc && nh == 0) {
    // dcum of the tile's rows for every head: each value's row sums over
    // the column tiles, then its column terms (the last position also the
    // d r sums and ga a); the loads of 4 values in flight at once
    const int rows = min(kTile, L - r0);
    for (int idx0 = tid; idx0 < A.heads * kTile; idx0 += 4 * kThreads) {
      float v[4];
      long long gi[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = idx0 + u * kThreads;
        const int h = idx / kTile, ii = idx - h * kTile;
        const bool ok = h < A.heads && ii < rows;
        const long long g = (long long)gbi * A.heads + (ok ? h : 0);
        const int i = r0 + (ok ? ii : 0);
        gi[u] = ok ? g * L + i : -1;
        float w[4];
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          w[jt] = jt <= t ? A.ws_row[(g * T + jt) * Lp + i] : 0.f;
        }
        v[u] = 0.f;
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) v[u] += w[jt];
        v[u] += A.ws_col[g * Lp + i];
        if (ok && i == L - 1) {
          float s = 0.f;
          for (int jt = 0; jt < T; ++jt) s += A.ws_dr[g * T + jt];
          v[u] += s + A.ga[g] * expf(A.cum[g * L + L - 1]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (gi[u] >= 0) A.dcum[gi[u]] = v[u];
      }
    }
  }
}

// Route 2's shared memory, in floats: every part a multiple of 4 (so that
// rows of 4 floats stay 16-byte aligned), for a batch of hb heads
// (kernels/ssd_scan.py::small_smem_bytes counts the same)
__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
struct SmallLayout {
  // B, C, C Bt, the heads' dCB and dB term; per head of the batch: X, gy,
  // gS, cum, d, d r, W, Q, dW o M, X gSt
  int b, c, cb, dcb, dbs, x, gy, gs, cum, d, dr, w, q, dwm, xg, total;
  __host__ __device__ SmallLayout(int L, int P, int N, int hb) {
    int at = 0;
    b = at;   at += r4(L * N);
    c = at;   at += r4(L * N);
    cb = at;  at += r4(L * L);
    dcb = at; at += r4(L * L);
    dbs = at; at += r4(L * N);
    x = at;   at += hb * r4(L * P);
    gy = at;  at += hb * r4(L * P);
    gs = at;  at += hb * r4(N * P);
    cum = at; at += hb * r4(L);
    d = at;   at += hb * r4(L);
    dr = at;  at += hb * r4(L);
    w = at;   at += hb * r4(L * L);
    q = at;   at += hb * r4(L * L);
    dwm = at; at += hb * r4(L * L);
    xg = at;  at += hb * r4(L * N);
    total = at;
  }
};

__device__ __forceinline__ float4 ldf4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void stf4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// a + x . y over 4 terms
__device__ __forceinline__ float dot4(float a, float4 x, float4 y) {
  a = fmaf(x.x, y.x, a);
  a = fmaf(x.y, y.y, a);
  a = fmaf(x.z, y.z, a);
  return fmaf(x.w, y.w, a);
}

// Route 2: every head of (batch, chunk) blockIdx.x, f32 FMAs, the heads
// in batches of A.per (the last may be smaller), each batch in five
// steps between barriers: load; C Bt (first batch) and d; the cells' dW,
// W, Q and X gSt; d r and the heads' dCB and dB term, summed in head
// order; dX and dcum.  Each sum runs in one thread in a fixed order.
template <bool kBf16>
__global__ void __launch_bounds__(kSmallThreads, 1)
ssd_bwd_small(const Args A) {
  extern __shared__ __align__(16) float sm[];
  const int L = A.L, P = A.P, N = A.N, H = A.heads, HB = A.per;
  const SmallLayout S(L, P, N, HB);
  const int LP = r4(L * P), NP = r4(N * P), LL = r4(L * L), LN = r4(L * N);
  const int L4 = r4(L);
  const int tid = threadIdx.x;
  const long long bc0 = (long long)blockIdx.x * L * N;
  float* Bs = sm + S.b;
  float* Cs = sm + S.c;

  for (int e = 4 * tid; e < L * N; e += 4 * kSmallThreads) {
    stf4(Bs + e, ld4<kBf16>(A.b, bc0 + e));
    stf4(Cs + e, ld4<kBf16>(A.c, bc0 + e));
  }
#pragma unroll 1
  for (int h0 = 0; h0 < H; h0 += HB) {
    const int hb = min(HB, H - h0);
    const long long g0 = (long long)blockIdx.x * H + h0;
    __syncthreads();                 // the last batch is done
    for (int e = 4 * tid; e < hb * L * P; e += 4 * kSmallThreads) {
      const int h = e / (L * P), o = e - h * (L * P);
      stf4(sm + S.x + h * LP + o, ldf4(A.xb + g0 * L * P + e));
      stf4(sm + S.gy + h * LP + o, ldf4(A.gy + g0 * L * P + e));
    }
    for (int e = 4 * tid; e < hb * N * P; e += 4 * kSmallThreads) {
      const int h = e / (N * P), o = e - h * (N * P);
      stf4(sm + S.gs + h * NP + o, ldf4(A.gs + g0 * N * P + e));
    }
    for (int e = tid; e < hb * L; e += kSmallThreads) {
      const int h = e / L, o = e - h * L;
      sm[S.cum + h * L4 + o] = A.cum[g0 * L + e];
    }
    __syncthreads();
    if (h0 == 0) {
      for (int idx = tid; idx < L * L; idx += kSmallThreads) {
        const int i = idx / L, j = idx - i * L;
        float s = 0.f;
        if (j <= i) {
          for (int n = 0; n < N; n += 4) {
            s = dot4(s, ldf4(Cs + i * N + n), ldf4(Bs + j * N + n));
          }
        }
        sm[S.cb + idx] = s;
      }
    }
    for (int e = tid; e < hb * L; e += kSmallThreads) {
      const int h = e / L, j = e - h * L;
      const float* cum = sm + S.cum + h * L4;
      sm[S.d + h * L4 + j] = expf(cum[L - 1] - cum[j]);
    }
    __syncthreads();
    // dW, W, Q and dW o M on and below the diagonal; X gSt
    for (int e = tid; e < hb * L * L; e += kSmallThreads) {
      const int h = e / (L * L), idx = e - h * (L * L);
      const int i = idx / L, j = idx - i * L;
      const float* x = sm + S.x + h * LP;
      const float* gy = sm + S.gy + h * LP;
      const float* cum = sm + S.cum + h * L4;
      float w = 0.f, q = 0.f, dm = 0.f;
      if (j <= i) {
        float dw = 0.f;
        for (int p = 0; p < P; p += 4) {
          dw = dot4(dw, ldf4(gy + i * P + p), ldf4(x + j * P + p));
        }
        const float m = expf(cum[i] - cum[j]);
        w = sm[S.cb + idx] * m;
        q = dw * w;
        dm = dw * m;
      }
      sm[S.w + h * LL + idx] = w;
      sm[S.q + h * LL + idx] = q;
      sm[S.dwm + h * LL + idx] = dm;
    }
    for (int e = tid; e < hb * L * N; e += kSmallThreads) {
      const int h = e / (L * N), idx = e - h * (L * N);
      const int j = idx / N, n = idx - j * N;
      const float* x = sm + S.x + h * LP;
      const float* gs = sm + S.gs + h * NP;
      float xg = 0.f;
      for (int p = 0; p < P; p += 4) {
        xg = dot4(xg, ldf4(x + j * P + p), ldf4(gs + n * P + p));
      }
      sm[S.xg + h * LN + idx] = xg;
    }
    __syncthreads();
    // d r of each cell's rows; the heads' dCB and dB term, in head order
    for (int e = tid; e < hb * L; e += kSmallThreads) {
      const int h = e / L, j = e - h * L;
      const float* xg = sm + S.xg + h * LN + j * N;
      float r = 0.f;
      for (int n = 0; n < N; ++n) r = fmaf(Bs[j * N + n], xg[n], r);
      sm[S.dr + h * L4 + j] = sm[S.d + h * L4 + j] * r;
    }
    for (int idx = tid; idx < L * L; idx += kSmallThreads) {
      float v = h0 == 0 ? 0.f : sm[S.dcb + idx];
      for (int h = 0; h < hb; ++h) v += sm[S.dwm + h * LL + idx];
      sm[S.dcb + idx] = v;
    }
    for (int idx = tid; idx < L * N; idx += kSmallThreads) {
      const int j = idx / N;
      float v = h0 == 0 ? 0.f : sm[S.dbs + idx];
      for (int h = 0; h < hb; ++h) {
        v += sm[S.d + h * L4 + j] * sm[S.xg + h * LN + idx];
      }
      sm[S.dbs + idx] = v;
    }
    __syncthreads();
    // dX and dcum of the batch's cells
    for (int e = tid; e < hb * L * P; e += kSmallThreads) {
      const int h = e / (L * P), idx = e - h * (L * P);
      const int j = idx / P, p = idx - j * P;
      const float* w = sm + S.w + h * LL;
      const float* gy = sm + S.gy + h * LP;
      const float* gs = sm + S.gs + h * NP;
      float v = 0.f, s = 0.f;
      for (int i = j; i < L; ++i) v = fmaf(w[i * L + j], gy[i * P + p], v);
      for (int n = 0; n < N; ++n) s = fmaf(Bs[j * N + n], gs[n * P + p], s);
      A.dx[g0 * L * P + e] = v + sm[S.d + h * L4 + j] * s;
    }
    for (int e = tid; e < hb * L; e += kSmallThreads) {
      const int h = e / L, i = e - h * L;
      const float* q = sm + S.q + h * LL;
      const float* dr = sm + S.dr + h * L4;
      float v = 0.f;
      for (int j = 0; j <= i; ++j) v += q[i * L + j];
      for (int k = i; k < L; ++k) v -= q[k * L + i];
      v -= dr[i];
      if (i == L - 1) {
        float s = 0.f;
        for (int j = 0; j < L; ++j) s += dr[j];
        v += s + A.ga[g0 + h] * expf(sm[S.cum + h * L4 + L - 1]);
      }
      A.dcum[g0 * L + e] = v;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < L * N; idx += kSmallThreads) {
    const int i = idx / N, n = idx - i * N;
    const float* dcb = sm + S.dcb;
    float dc = 0.f, db = sm[S.dbs + idx];
    for (int j = 0; j <= i; ++j) dc = fmaf(dcb[i * L + j], Bs[j * N + n], dc);
    for (int k = i; k < L; ++k) db = fmaf(dcb[k * L + i], Cs[k * N + n], db);
    A.dc[bc0 + idx] = dc;
    A.db[bc0 + idx] = db;
  }
}

const void* const kKernels[8] = {
    (const void*)ssd_bwd_cols<false>,  (const void*)ssd_bwd_cols<true>,
    (const void*)ssd_bwd_rows<false>,  (const void*)ssd_bwd_rows<true>,
    (const void*)ssd_bwd_small<false>, (const void*)ssd_bwd_small<true>,
    (const void*)ssd_bwd_cb<false>,    (const void*)ssd_bwd_cb<true>};
constexpr int kSmemCbBytes = (4 * kOpBig + kOpBig) * (int)sizeof(float);

// the dynamic shared memory every launch may ask for, set once per process
cudaError_t configure_once() {
  static cudaError_t status = [] {
    const int bytes[8] = {kSmem1Bytes, kSmem1Bytes, kSmem2Bytes,
                          kSmem2Bytes, kSmemMax,    kSmemMax,
                          kSmemCbBytes, kSmemCbBytes};
    for (int i = 0; i < 8; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          kKernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes[i]);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return status;
}

}  // namespace

extern "C" {

// The backward of the intra-chunk SSD over G cells.  `a` holds 27 64-bit
// values (kernels/ssd_scan.py::bwd_layout packs them): the device
// addresses of xb (G, L, P), b and c (G / heads, L, N; f32, or bf16 where
// a[13] is 1), cum (G, 1, L), gy (G, L, P), gs (G, N, P), ga (G, 1), then
// of the outputs dxb (G, L, P), db and dc (G / heads, L, N, f32), dcum
// (G, 1, L), of the workspace (route 1), the stream; then bc_bf16, G,
// heads, L, P, N, the route (1 or 2), `per` heads a head group (route 1)
// and the offsets in floats from the workspace of ws_dcb, ws_db, ws_row,
// ws_col, ws_dr and ws_cb (Args says their shapes; no initial values
// needed).  Route 1 makes three launches, four where there are several
// head groups; route 2 one.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels
// do not take.
int ssd_scan_bwd_run(const long long* a) {
  const int bf16 = (int)a[13], G = (int)a[14], heads = (int)a[15];
  const int L = (int)a[16], P = (int)a[17], N = (int)a[18];
  const int route = (int)a[19], per = (int)a[20];
  if (L < 1 || L > kMaxL || P < 4 || P > kMaxP || P % 4 || N < 4 ||
      N > kMaxN || N % 4 || heads < 1 || G < 0 || G % heads ||
      (route != 1 && route != 2) || per < 1 ||
      (route == 1 && heads % per)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return (int)cudaGetLastError();
  auto ptr = [](long long v) { return reinterpret_cast<void*>(v); };
  Args A;
  A.xb = reinterpret_cast<const float*>(ptr(a[0]));
  A.b = ptr(a[1]);
  A.c = ptr(a[2]);
  A.cum = reinterpret_cast<const float*>(ptr(a[3]));
  A.gy = reinterpret_cast<const float*>(ptr(a[4]));
  A.gs = reinterpret_cast<const float*>(ptr(a[5]));
  A.ga = reinterpret_cast<const float*>(ptr(a[6]));
  A.dx = reinterpret_cast<float*>(ptr(a[7]));
  A.db = reinterpret_cast<float*>(ptr(a[8]));
  A.dc = reinterpret_cast<float*>(ptr(a[9]));
  A.dcum = reinterpret_cast<float*>(ptr(a[10]));
  float* ws = reinterpret_cast<float*>(ptr(a[11]));
  const cudaStream_t st = (cudaStream_t)ptr(a[12]);
  A.G = G;
  A.heads = heads;
  A.L = L;
  A.P = P;
  A.N = N;
  A.gb = G / heads;
  if (route == 2) {
    A.per = per;
    const int bytes = SmallLayout(L, P, N, per).total * (int)sizeof(float);
    if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
    if (bf16) {
      ssd_bwd_small<true><<<A.gb, kSmallThreads, bytes, st>>>(A);
    } else {
      ssd_bwd_small<false><<<A.gb, kSmallThreads, bytes, st>>>(A);
    }
    return (int)cudaGetLastError();
  }
  A.per = per;
  A.groups = heads / per;
  A.tiles = (L + kTile - 1) / kTile;
  A.chunks = (N + kTile - 1) / kTile;
  A.Lp = A.tiles * kTile;
  A.Np = A.chunks * kTile;
  A.ws_dcb = ws + a[21];
  A.ws_db = ws + a[22];
  A.ws_row = ws + a[23];
  A.ws_col = ws + a[24];
  A.ws_dr = ws + a[25];
  A.ws_cb = ws + a[26];
  const int npair = A.tiles * (A.tiles + 1) / 2;
  const dim3 grid1(A.tiles * A.gb * A.groups);
  const dim3 grid2(A.tiles * A.gb * A.chunks * 2);
  if (bf16) {
    ssd_bwd_cb<true><<<A.gb * npair, kThreads, kSmemCbBytes, st>>>(A);
    ssd_bwd_cols<true><<<grid1, kThreads, kSmem1Bytes, st>>>(A);
  } else {
    ssd_bwd_cb<false><<<A.gb * npair, kThreads, kSmemCbBytes, st>>>(A);
    ssd_bwd_cols<false><<<grid1, kThreads, kSmem1Bytes, st>>>(A);
  }
  if (A.groups > 1) {
    const long long f4 = (long long)A.gb * (npair * (kOp / 4) +
                                            A.Lp * A.Np / 4);
    const int blocks = (int)min((f4 + kThreads - 1) / kThreads, 132LL * 8);
    ssd_bwd_sum<<<blocks, kThreads, 0, st>>>(A);
    A.groups = 1;                    // pass 2 reads group 0's sums
  }
  if (bf16) {
    ssd_bwd_rows<true><<<grid2, kThreads, kSmem2Bytes, st>>>(A);
  } else {
    ssd_bwd_rows<false><<<grid2, kThreads, kSmem2Bytes, st>>>(A);
  }
  return (int)cudaGetLastError();
}

// Registers, local (spilled) bytes and the dynamic shared memory set for
// kernel k: 0-1 pass 1, 2-3 pass 2, 4-5 route 2, 6-7 pass 0 (f32 b and c,
// then bf16).
int ssd_scan_bwd_attrs(int k, int* out) {
  if (k < 0 || k >= 8) return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes at;
  const cudaError_t e = cudaFuncGetAttributes(&at, kKernels[k]);
  if (e != cudaSuccess) return (int)e;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = at.maxDynamicSharedSizeBytes;
  return 0;
}

}  // extern "C"
