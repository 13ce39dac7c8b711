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
// dC and dB once per (batch, chunk)) and moves about 63 MB: 67 us at the
// 67 TFLOP/s f32 rate, 19 us of bytes at 3.35 TB/s.  It is bound by its
// operations.
//
// The design, simple first (f32 FMAs on tiles in shared memory, no tensor
// cores; split TF32 on wgmma, as the forward has, is later work):
// * Pass 1, one CTA per (batch, chunk, 32-column tile j, head group).  It
//   forms CB for its columns and every row at or below them once, for the
//   heads of its group, and keeps it in registers (each thread 8 rows x 4
//   columns).  For each head it forms dW, W and Q there; the sum of dCB
//   over the group's heads stays in registers too.  It owns dX of its
//   columns (complete: the sum over rows runs inside the CTA, as a
//   FlashAttention-2 backward owns dK and dV), the column terms of dcum
//   (-colsum(Q) - d r), the row sums of Q over its 32 columns, and its
//   group's share of dB (dCBt C plus d o (X gSt)) and of dCB.
// * Pass 2, one CTA per (batch, chunk, 32-row tile i).  It sums the head
//   groups' dCB rows and forms dC = dCB B on and below the diagonal, sums
//   the groups' dB, and adds up dcum.
// * Tiles above the diagonal are skipped; the mask sits in the exponent
//   (a term above the diagonal is zero before its exp).
// * No float atomics: every sum runs in one thread, a fixed shuffle tree
//   or a fixed loop over head groups, so the gradient is the same from run
//   to run.  The head groups (kernels/ssd_scan.py::bwd_plan) exist only to
//   fill the card when (batch, chunk) groups are few; their partial dCB
//   and dB go through a device workspace the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;               // columns (pass 1), rows (pass 2)
constexpr int kThreads = 256;
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 128;
constexpr int kRows = kMaxL / (kThreads / 8);   // rows a thread owns: 8
constexpr int kHalf = 128;           // rows of C staged at once

// shared-memory pitches, in floats
constexpr int kPB = kMaxN + 1;       // B rows of the column tile
constexpr int kPC = kMaxN + 4;       // staged C (or B) rows
constexpr int kPG = kMaxP + 4;       // gy rows
constexpr int kPX = kMaxP + 4;       // X rows, gS rows
constexpr int kPD = kT + 4;          // summed dCB, transposed (pass 2)

// pass 1's shared memory, in floats
constexpr int kOffBn = 0;
constexpr int kOffBt = kOffBn + kT * kPB;              // Bt: N x 32
constexpr int kOffR = kOffBt + kMaxN * kT;             // gy rows, or C rows
constexpr int kSizeR =
    kMaxL * kPG > kHalf * kPC ? kMaxL * kPG : kHalf * kPC;
constexpr int kOffW = kOffR + kSizeR;                  // W, then dCB: L x 32
constexpr int kOffXt = kOffW + kMaxL * kT;             // Xt: P x 32
constexpr int kOffXn = kOffXt + kMaxP * kT;            // X: 32 x P
constexpr int kOffGs = kOffXn + kT * kPX;              // gS: N x P
constexpr int kOffCum = kOffGs + kMaxN * kPX;          // cum of the cell
constexpr int kOffD = kOffCum + kMaxL;                 // d of the columns
constexpr int kOffRed = kOffD + kT;                    // 32 x 32 col sums
constexpr int kOffColQ = kOffRed + (kThreads / 8) * kT;
constexpr int kOffDr = kOffColQ + kT;
constexpr int kSmem1 = kOffDr + kT;
constexpr int kSmem1Bytes = kSmem1 * (int)sizeof(float);

// pass 2's shared memory, in floats
constexpr int kChunkB = 64;          // rows of B staged at once
constexpr int kSmem2 = kMaxL * kPD + kChunkB * kPC;
constexpr int kSmem2Bytes = kSmem2 * (int)sizeof(float);

static_assert(kOffBt % 4 == 0 && kOffR % 4 == 0 && kOffW % 4 == 0 &&
              kOffXt % 4 == 0 && kOffXn % 4 == 0 && kOffGs % 4 == 0 &&
              kPX % 4 == 0 && kPG % 4 == 0 && kPC % 4 == 0,
              "float4 operands must be 16-byte aligned");
static_assert(kSmem1Bytes <= 232448, "pass 1 must fit one SM");
static_assert(kOffD % 4 == 0 && kPD % 4 == 0 && kMaxL * kPD % 4 == 0 &&
              4 * kT * kMaxP <= kMaxL * kT && kT * kMaxN <= kMaxN * kPX,
              "the partial sums must fit where W and gS were");

struct Args {
  const float* xb;
  const void* b;
  const void* c;
  const float* cum;
  const float* gy;
  const float* gs;
  const float* ga;
  int G, heads, L, P, N, per, groups, gb, tiles;
  float* dx;
  float* db;
  float* dc;
  float* dcum;
  float* ws_dcb;   // (groups, gb, L, L): each head group's dCB
  float* ws_db;    // (groups, gb, L, N): each head group's dB
  float* ws_row;   // (G, tiles, L): rowsum(Q) over each column tile
  float* ws_col;   // (G, L): -colsum(Q) - d r
  float* ws_dr;    // (G, tiles): sum of d r over each column tile
};

// 4 values of row-major b or c at element e (a multiple of 4), widened
// from bf16 exactly (bf16 is the high half of an f32)
template <bool kBf16>
__device__ __forceinline__ float4 ld4(const void* p, long long e) {
  if (kBf16) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const unsigned short*>(p) + e);
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) +
                                          e);
}

__device__ __forceinline__ float4 ldf4(const float* p, long long e) {
  return *reinterpret_cast<const float4*>(p + e);
}

__device__ __forceinline__ void put4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [row0, row0 + rows) of an (L, N) b or c matrix of (batch, chunk)
// gbi into dst with pitch kPC (rows past L zero)
template <bool kBf16>
__device__ void stage_rows(const void* src, int gbi, int L, int N, int row0,
                           int rows, float* dst) {
  const int q4 = N / 4;
  for (int idx = threadIdx.x; idx < rows * q4; idx += kThreads) {
    const int r = idx / q4, q = idx - r * q4;
    const int i = row0 + r;
    const float4 v = i < L ? ld4<kBf16>(src, ((long long)gbi * L + i) * N +
                                                 4 * q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    put4(dst + r * kPC + 4 * q, v);
  }
}

// asynchronous copy of kBytes from device to shared memory
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(kBytes)
                 : "memory");
  }
}

// every copy this thread started has landed, then every thread's has
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// a + x . y over 4 terms
__device__ __forceinline__ float dot4(float a, float4 x, float4 y) {
  a = fmaf(x.x, y.x, a);
  a = fmaf(x.y, y.y, a);
  a = fmaf(x.z, y.z, a);
  return fmaf(x.w, y.w, a);
}

__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Pass 1: the column tile jt of (batch, chunk) gbi for head group hg.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cols(const Args A) {
  extern __shared__ __align__(16) float sm[];
  float* Bn = sm + kOffBn;
  float* Bt = sm + kOffBt;
  float* R = sm + kOffR;
  float* Ws = sm + kOffW;
  float* Xt = sm + kOffXt;
  float* Xn = sm + kOffXn;
  float* Gs = sm + kOffGs;
  float* cum_s = sm + kOffCum;
  float* d_s = sm + kOffD;
  float* red = sm + kOffRed;
  float* colq = sm + kOffColQ;
  float* dr_s = sm + kOffDr;

  const int L = A.L, P = A.P, N = A.N;
  const int per_tile = A.gb * A.groups;
  const int jt = blockIdx.x / per_tile;             // longest tiles first
  const int rem = blockIdx.x - jt * per_tile;
  const int gbi = rem / A.groups, hg = rem - gbi * A.groups;
  const int j0 = jt * kT;
  const int nrow = L - j0;                          // rows [j0, L)
  const int ncol = min(kT, nrow);                   // columns [j0, j0+ncol)
  const int h0 = hg * A.per, h1 = min(A.heads, h0 + A.per);
  const int t = threadIdx.x;
  const int tc = t & 7, tr = t >> 3;                // (4 columns, 8 rows)
  const int lane = t & 31, wv = t >> 5;

  // B rows of the column tile: natural and transposed (zero past L)
  {
    const int q4 = N / 4;
    for (int idx = t; idx < kT * q4; idx += kThreads) {
      const int jc = idx / q4, q = idx - jc * q4;
      const float4 v =
          jc < ncol ? ld4<kBf16>(A.b, ((long long)gbi * L + j0 + jc) * N +
                                          4 * q)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      float* bn = Bn + jc * kPB + 4 * q;
      bn[0] = v.x; bn[1] = v.y; bn[2] = v.z; bn[3] = v.w;
      Bt[(4 * q) * kT + jc] = v.x;
      Bt[(4 * q + 1) * kT + jc] = v.y;
      Bt[(4 * q + 2) * kT + jc] = v.z;
      Bt[(4 * q + 3) * kT + jc] = v.w;
    }
  }

  // CB of this thread's rows j0 + tr + 32k and columns j0 + 4tc + q, once
  // for the head group; C staged 128 rows at a time
  float cb[kRows][4];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) cb[k][q] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < kMaxL / kHalf; ++h) {
    if (h * kHalf < nrow) {
      __syncthreads();
      stage_rows<kBf16>(A.c, gbi, L, N, j0 + h * kHalf,
                        min(kHalf, nrow - h * kHalf), R);
      __syncthreads();
      for (int n = 0; n < N; n += 4) {
        // B of the 4 columns at n .. n + 3, one float4 a column
        const float4 b0 = ldf4(Bt, n * kT + 4 * tc);
        const float4 b1 = ldf4(Bt, (n + 1) * kT + 4 * tc);
        const float4 b2 = ldf4(Bt, (n + 2) * kT + 4 * tc);
        const float4 b3 = ldf4(Bt, (n + 3) * kT + 4 * tc);
        const float4 bq0 = make_float4(b0.x, b1.x, b2.x, b3.x);
        const float4 bq1 = make_float4(b0.y, b1.y, b2.y, b3.y);
        const float4 bq2 = make_float4(b0.z, b1.z, b2.z, b3.z);
        const float4 bq3 = make_float4(b0.w, b1.w, b2.w, b3.w);
#pragma unroll
        for (int kk = 0; kk < kHalf / 32; ++kk) {
          const float4 cv = ldf4(R, (tr + 32 * kk) * kPC + n);
          const int k = h * (kHalf / 32) + kk;
          cb[k][0] = dot4(cb[k][0], cv, bq0);
          cb[k][1] = dot4(cb[k][1], cv, bq1);
          cb[k][2] = dot4(cb[k][2], cv, bq2);
          cb[k][3] = dot4(cb[k][3], cv, bq3);
        }
      }
    }
  }

  float dcb[kRows][4];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dcb[k][q] = 0.f;
  }
  // this thread's share of dB's d o (X gSt) term, summed over the heads:
  // columns jc = wv + 8m, n = lane + 32mm
  float dbx[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) dbx[m][mm] = 0.f;
  }

  for (int head = h0; head < h1; ++head) {
    const long long g = (long long)gbi * A.heads + head;
    __syncthreads();               // the last head is done with smem
    // gy rows [j0, L), X rows of the tile, gS and cum of the cell, all in
    // flight at once; then X transposed
    {
      const int q4 = P / 4;
      for (int idx = t; idx < nrow * q4; idx += kThreads) {
        const int r = idx / q4, q = idx - r * q4;
        cp_async<16>(R + r * kPG + 4 * q, A.gy + (g * L + j0 + r) * P + 4 * q);
      }
      for (int idx = t; idx < kT * q4; idx += kThreads) {
        const int jc = idx / q4, q = idx - jc * q4;
        if (jc < ncol) {
          cp_async<16>(Xn + jc * kPX + 4 * q,
                       A.xb + (g * L + j0 + jc) * P + 4 * q);
        } else {
          put4(Xn + jc * kPX + 4 * q, make_float4(0.f, 0.f, 0.f, 0.f));
        }
      }
      for (int idx = t; idx < N * q4; idx += kThreads) {
        const int n = idx / q4, q = idx - n * q4;
        cp_async<16>(Gs + n * kPX + 4 * q, A.gs + (g * N + n) * P + 4 * q);
      }
      for (int i = t; i < L; i += kThreads) {
        cp_async<4>(cum_s + i, A.cum + g * L + i);
      }
    }
    cp_async_wait();
    for (int idx = t; idx < kT * P; idx += kThreads) {
      const int p = idx / kT, jc = idx - p * kT;
      Xt[p * kT + jc] = Xn[jc * kPX + p];
    }
    if (t < kT) {
      d_s[t] = t < ncol ? expf(cum_s[L - 1] - cum_s[j0 + t]) : 0.f;
    }
    __syncthreads();

    // dW of this thread's 8 x 4 entries, then W, dCB and Q there
    float dw[kRows][4];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dw[k][q] = 0.f;
    }
    for (int p = 0; p < P; p += 4) {
      // X of the 4 columns at p .. p + 3
      const float4 x0 = ldf4(Xt, p * kT + 4 * tc);
      const float4 x1 = ldf4(Xt, (p + 1) * kT + 4 * tc);
      const float4 x2 = ldf4(Xt, (p + 2) * kT + 4 * tc);
      const float4 x3 = ldf4(Xt, (p + 3) * kT + 4 * tc);
      const float4 xq0 = make_float4(x0.x, x1.x, x2.x, x3.x);
      const float4 xq1 = make_float4(x0.y, x1.y, x2.y, x3.y);
      const float4 xq2 = make_float4(x0.z, x1.z, x2.z, x3.z);
      const float4 xq3 = make_float4(x0.w, x1.w, x2.w, x3.w);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        // rows past L read stale values inside R; their results are
        // discarded below
        const float4 gv = ldf4(R, (tr + 32 * k) * kPG + p);
        dw[k][0] = dot4(dw[k][0], gv, xq0);
        dw[k][1] = dot4(dw[k][1], gv, xq1);
        dw[k][2] = dot4(dw[k][2], gv, xq2);
        dw[k][3] = dot4(dw[k][3], gv, xq3);
      }
    }
    float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = tr + 32 * k;                    // row j0 + r
      float rq = 0.f;
      float wk[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jc = 4 * tc + q;
        const bool on = r < nrow && jc <= r;        // i < L and j <= i
        // the mask before the exp
        const float m = on ? expf(cum_s[j0 + r] - cum_s[j0 + jc]) : 0.f;
        const float w = on ? cb[k][q] * m : 0.f;
        const float qv = on ? dw[k][q] * w : 0.f;
        dcb[k][q] += on ? dw[k][q] * m : 0.f;
        wk[q] = w;
        rq += qv;
        colp[q] += qv;
      }
      if (r < nrow) {
        put4(Ws + r * kT + 4 * tc, make_float4(wk[0], wk[1], wk[2], wk[3]));
      }
      rq = warp_sum(rq, 8);                         // over the 8 tc lanes
      if (tc == 0 && r < nrow) {
        A.ws_row[(g * A.tiles + jt) * L + j0 + r] = rq;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) red[tr * kT + 4 * tc + q] = colp[q];
    __syncthreads();               // W, the column partials, d
    if (t < kT) {
      float s = 0.f;
      for (int i = 0; i < kThreads / 8; ++i) s += red[i * kT + t];
      colq[t] = s;
    }

    // dX of the tile.  Each thread sums 4 columns x 8 p over a quarter
    // of the rows and a quarter of the state's n (grp = t / 64); the
    // quarters meet in shared memory (where W was) and are added in a
    // fixed order
    {
      const int grp = t >> 6, u = t & 63;
      const int cq = u >> 3, p0 = 8 * (u & 7);
      float acc[4][8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[e][k] = 0.f;
      }
      for (int r = grp; r < nrow; r += 4) {
        // W is zero above the diagonal and past the tile's columns
        const float4 w = ldf4(Ws, r * kT + 4 * cq);
        const float4 g0 = ldf4(R, r * kPG + p0);
        const float4 g1 = ldf4(R, r * kPG + p0 + 4);
        const float we[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e][0] = fmaf(we[e], g0.x, acc[e][0]);
          acc[e][1] = fmaf(we[e], g0.y, acc[e][1]);
          acc[e][2] = fmaf(we[e], g0.z, acc[e][2]);
          acc[e][3] = fmaf(we[e], g0.w, acc[e][3]);
          acc[e][4] = fmaf(we[e], g1.x, acc[e][4]);
          acc[e][5] = fmaf(we[e], g1.y, acc[e][5]);
          acc[e][6] = fmaf(we[e], g1.z, acc[e][6]);
          acc[e][7] = fmaf(we[e], g1.w, acc[e][7]);
        }
      }
      const float4 dq = ldf4(d_s, 4 * cq);
      for (int n = grp; n < N; n += 4) {
        const float4 bv = ldf4(Bt, n * kT + 4 * cq);
        const float bd[4] = {bv.x * dq.x, bv.y * dq.y, bv.z * dq.z,
                             bv.w * dq.w};
        const float4 s0 = ldf4(Gs, n * kPX + p0);
        const float4 s1 = ldf4(Gs, n * kPX + p0 + 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e][0] = fmaf(bd[e], s0.x, acc[e][0]);
          acc[e][1] = fmaf(bd[e], s0.y, acc[e][1]);
          acc[e][2] = fmaf(bd[e], s0.z, acc[e][2]);
          acc[e][3] = fmaf(bd[e], s0.w, acc[e][3]);
          acc[e][4] = fmaf(bd[e], s1.x, acc[e][4]);
          acc[e][5] = fmaf(bd[e], s1.y, acc[e][5]);
          acc[e][6] = fmaf(bd[e], s1.z, acc[e][6]);
          acc[e][7] = fmaf(bd[e], s1.w, acc[e][7]);
        }
      }
      __syncthreads();             // every thread is done with W
      float* part = Ws;            // [4 quarters][32 columns][64 p]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* o = part + (grp * kT + 4 * cq + e) * kMaxP + p0;
        put4(o, make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]));
        put4(o + 4, make_float4(acc[e][4], acc[e][5], acc[e][6], acc[e][7]));
      }
      __syncthreads();
      const int jc = t >> 3, pp = 8 * (t & 7);
      if (jc < ncol) {
        float* out = A.dx + (g * L + j0 + jc) * P;
#pragma unroll
        for (int h4 = 0; h4 < 2; ++h4) {
          const int p = pp + 4 * h4;
          if (p < P) {
            float4 v = ldf4(part, jc * kMaxP + p);
#pragma unroll
            for (int q = 1; q < 4; ++q) {
              const float4 o = ldf4(part, (q * kT + jc) * kMaxP + p);
              v = make_float4(v.x + o.x, v.y + o.y, v.z + o.z, v.w + o.w);
            }
            put4(out + p, v);
          }
        }
      }
    }
    __syncthreads();               // colq

    // X gSt of the tile (columns wv + 8m, n = lane + 32mm): dB's term and
    // r, then the column terms of dcum
    {
      float xg[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) xg[m][mm] = 0.f;
      }
      for (int p = 0; p < P; p += 4) {
        float4 xv[4], sv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) xv[m] = ldf4(Xn, (wv + 8 * m) * kPX + p);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          sv[mm] = ldf4(Gs, (lane + 32 * mm) * kPX + p);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            xg[m][mm] = dot4(xg[m][mm], xv[m], sv[mm]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jc = wv + 8 * m;
        const float dj = d_s[jc];
        float rp = 0.f;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int n = lane + 32 * mm;
          const bool on = jc < ncol && n < N;
          dbx[m][mm] += on ? dj * xg[m][mm] : 0.f;
          rp += on ? Bn[jc * kPB + n] * xg[m][mm] : 0.f;
        }
        rp = warp_sum(rp, 32);
        if (lane == 0) {
          const float dr = jc < ncol ? dj * rp : 0.f;
          if (jc < ncol) A.ws_col[g * L + j0 + jc] = -colq[jc] - dr;
          dr_s[jc] = dr;
        }
      }
    }
    __syncthreads();               // dr_s
    if (t < kT) {
      const float s = warp_sum(dr_s[t], 32);
      if (t == 0) A.ws_dr[g * A.tiles + jt] = s;
    }
  }

  // the head group's dCB of the tile: to the workspace, and to Ws for dB;
  // the d o (X gSt) term of dB to where gS was, as the threads of the dB
  // product below hold other columns
  __syncthreads();                 // the last head is done with Ws and gS
  float* dbxs = Gs;                // [32 columns][kMaxN]
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      dbxs[(wv + 8 * m) * kMaxN + lane + 32 * mm] = dbx[m][mm];
    }
  }
  float* wsd = A.ws_dcb + ((long long)hg * A.gb + gbi) * L * L;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = tr + 32 * k;
    if (r < nrow) {
      put4(Ws + r * kT + 4 * tc,
           make_float4(dcb[k][0], dcb[k][1], dcb[k][2], dcb[k][3]));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * tc + q < ncol) {
          wsd[(long long)(j0 + r) * L + j0 + 4 * tc + q] = dcb[k][q];
        }
      }
    }
  }
  // dB of the tile's rows: dCBt C + the d o (X gSt) term; each thread 4
  // columns (4 (t / 32) + e) x 4 n (4 lane + f)
  const int cq = wv, n0 = 4 * lane;
  float acc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
  }
  for (int h = 0; h * kHalf < nrow; ++h) {
    __syncthreads();
    const int rows = min(kHalf, nrow - h * kHalf);
    stage_rows<kBf16>(A.c, gbi, L, N, j0 + h * kHalf, rows, R);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float4 w = ldf4(Ws, (h * kHalf + r) * kT + 4 * cq);
      const float4 cv = ldf4(R, r * kPC + n0);
      const float we[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e][0] = fmaf(we[e], cv.x, acc[e][0]);
        acc[e][1] = fmaf(we[e], cv.y, acc[e][1]);
        acc[e][2] = fmaf(we[e], cv.z, acc[e][2]);
        acc[e][3] = fmaf(we[e], cv.w, acc[e][3]);
      }
    }
  }
  float* wsb = A.ws_db + ((long long)hg * A.gb + gbi) * L * N;
  if (n0 < N) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jc = 4 * cq + e;
      if (jc < ncol) {
        const float4 x = ldf4(dbxs, jc * kMaxN + n0);
        put4(wsb + (long long)(j0 + jc) * N + n0,
             make_float4(acc[e][0] + x.x, acc[e][1] + x.y, acc[e][2] + x.z,
                         acc[e][3] + x.w));
      }
    }
  }
}

// Pass 2: the row tile it of (batch, chunk) gbi: dC, dB and dcum.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_rows(const Args A) {
  extern __shared__ __align__(16) float sm[];
  float* Dt = sm;                      // summed dCB, transposed: j x 32
  float* Bs = sm + kMaxL * kPD;        // B rows, 64 at a time

  const int L = A.L, N = A.N, gb = A.gb;
  const int it = A.tiles - 1 - (int)blockIdx.x / gb;   // longest first
  const int gbi = (int)blockIdx.x - ((int)blockIdx.x / gb) * gb;
  const int i0 = it * kT;
  const int nr = min(kT, L - i0);
  const int jmax = min(L, i0 + kT);
  const int t = threadIdx.x, lane = t & 31, wv = t >> 5;
  const long long plane = (long long)gb * L * L;

  // the head groups' dCB of rows [i0, i0 + 32), columns j <= i, summed in
  // a fixed order (read along rows, stored transposed)
  for (int idx = t; idx < kT * jmax; idx += kThreads) {
    const int ii = idx / jmax, j = idx - ii * jmax;
    float v = 0.f;
    if (ii < nr && j <= i0 + ii) {
      const float* src = A.ws_dcb + ((long long)gbi * L + i0 + ii) * L + j;
      for (int hg = 0; hg < A.groups; ++hg) v += src[hg * plane];
    }
    Dt[j * kPD + ii] = v;
  }
  // dC of the tile: each thread rows 4 (t / 32) + e, n = 4 lane + f
  const int n0 = 4 * lane;
  float acc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[e][f] = 0.f;
  }
  for (int c0 = 0; c0 < jmax; c0 += kChunkB) {
    const int rows = min(kChunkB, jmax - c0);
    __syncthreads();
    stage_rows<kBf16>(A.b, gbi, L, N, c0, rows, Bs);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float4 d = ldf4(Dt, (c0 + r) * kPD + 4 * wv);
      const float4 bv = ldf4(Bs, r * kPC + n0);
      const float de[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e][0] = fmaf(de[e], bv.x, acc[e][0]);
        acc[e][1] = fmaf(de[e], bv.y, acc[e][1]);
        acc[e][2] = fmaf(de[e], bv.z, acc[e][2]);
        acc[e][3] = fmaf(de[e], bv.w, acc[e][3]);
      }
    }
  }
  if (n0 < N) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ii = 4 * wv + e;
      if (ii < nr) {
        put4(A.dc + ((long long)gbi * L + i0 + ii) * N + n0,
             make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]));
      }
    }
  }
  // dB: the head groups' shares, in a fixed order
  const long long bplane = (long long)gb * L * N;
  for (int idx = t; idx < nr * N; idx += kThreads) {
    const long long e = ((long long)gbi * L + i0) * N + idx;
    float v = 0.f;
    for (int hg = 0; hg < A.groups; ++hg) v += A.ws_db[hg * bplane + e];
    A.db[e] = v;
  }
  // dcum of the tile's rows, for every head of the (batch, chunk)
  for (int idx = t; idx < A.heads * nr; idx += kThreads) {
    const int h = idx / nr, ii = idx - h * nr;
    const long long g = (long long)gbi * A.heads + h;
    const int i = i0 + ii;
    float v = 0.f;
    for (int jt = 0; jt <= it; ++jt) v += A.ws_row[(g * A.tiles + jt) * L + i];
    v += A.ws_col[g * L + i];
    if (i == L - 1) {
      float s = 0.f;
      for (int jt = 0; jt < A.tiles; ++jt) s += A.ws_dr[g * A.tiles + jt];
      v += s + A.ga[g] * expf(A.cum[g * L + L - 1]);
    }
    A.dcum[g * L + i] = v;
  }
}

// the dynamic shared memory every launch asks for, set once per process
cudaError_t configure_once() {
  static cudaError_t status = [] {
    const void* fns[4] = {(const void*)ssd_bwd_cols<false>,
                          (const void*)ssd_bwd_cols<true>,
                          (const void*)ssd_bwd_rows<false>,
                          (const void*)ssd_bwd_rows<true>};
    const int bytes[4] = {kSmem1Bytes, kSmem1Bytes, kSmem2Bytes,
                          kSmem2Bytes};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t e = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes[i]);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return status;
}

}  // namespace

extern "C" {

// The backward of the intra-chunk SSD over G cells on `stream`: inputs as
// ssd_scan_launch takes them (xb (G, L, P), b and c (G / heads, L, N) f32
// or bf16 (bc_bf16 = 1), cum (G, 1, L)), the cotangents gy (G, L, P), gs
// (G, N, P), ga (G, 1) in f32, `per` heads a head group -> dxb (G, L, P),
// db and dc (G / heads, L, N) in f32, dcum (G, 1, L).  The workspace
// (groups = ceil(heads / per), tiles = ceil(L / 32), gb = G / heads):
// ws_dcb (groups, gb, L, L), ws_db (groups, gb, L, N), ws_row (G, tiles,
// L), ws_col (G, L), ws_dr (G, tiles), f32, no initial values needed.
// Two launches; returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape the kernel does not take.
int ssd_scan_bwd_launch(const void* xb, const void* b, const void* c,
                        const void* cum, const void* gy, const void* gs,
                        const void* ga, int bc_bf16, int G, int heads,
                        int L, int P, int N, int per, void* dx, void* db,
                        void* dc, void* dcum, void* ws_dcb, void* ws_db,
                        void* ws_row, void* ws_col, void* ws_dr,
                        void* stream) {
  if (L < 1 || L > kMaxL || P < 4 || P > kMaxP || P % 4 || N < 4 ||
      N > kMaxN || N % 4 || heads < 1 || G < 0 || G % heads || per < 1 ||
      per > heads) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  if (G == 0) return (int)cudaGetLastError();
  Args A;
  A.xb = reinterpret_cast<const float*>(xb);
  A.b = b;
  A.c = c;
  A.cum = reinterpret_cast<const float*>(cum);
  A.gy = reinterpret_cast<const float*>(gy);
  A.gs = reinterpret_cast<const float*>(gs);
  A.ga = reinterpret_cast<const float*>(ga);
  A.G = G;
  A.heads = heads;
  A.L = L;
  A.P = P;
  A.N = N;
  A.per = per;
  A.groups = (heads + per - 1) / per;
  A.gb = G / heads;
  A.tiles = (L + kT - 1) / kT;
  A.dx = reinterpret_cast<float*>(dx);
  A.db = reinterpret_cast<float*>(db);
  A.dc = reinterpret_cast<float*>(dc);
  A.dcum = reinterpret_cast<float*>(dcum);
  A.ws_dcb = reinterpret_cast<float*>(ws_dcb);
  A.ws_db = reinterpret_cast<float*>(ws_db);
  A.ws_row = reinterpret_cast<float*>(ws_row);
  A.ws_col = reinterpret_cast<float*>(ws_col);
  A.ws_dr = reinterpret_cast<float*>(ws_dr);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid1(A.tiles * A.gb * A.groups), grid2(A.tiles * A.gb);
  if (bc_bf16) {
    ssd_bwd_cols<true><<<grid1, kThreads, kSmem1Bytes, st>>>(A);
  } else {
    ssd_bwd_cols<false><<<grid1, kThreads, kSmem1Bytes, st>>>(A);
  }
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  if (bc_bf16) {
    ssd_bwd_rows<true><<<grid2, kThreads, kSmem2Bytes, st>>>(A);
  } else {
    ssd_bwd_rows<false><<<grid2, kThreads, kSmem2Bytes, st>>>(A);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
