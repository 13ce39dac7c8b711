// attention.cu -- kernel D: causal self-attention, forward and backward, on
// the tensor cores in split TF32.
//
// Replaces no Pallas kernel: the JAX package leaves attention to XLA, which
// fuses it.  The port's eager plain form (models/attention.py::
// _plain_attention) writes the whole S x S f32 score matrix of every head
// and passes over it again for the scaling, the mask and the softmax, and
// as often in its backward.  Here the scores live in registers a tile at a
// time (the online softmax of flash attention), tiles above the diagonal
// are skipped, and nothing of size S^2 reaches device memory.
//
// What it computes (the plain form's arithmetic): q (B, S, H, hd), k and v
// (B, S, G, hd), H = G rep, q head h reading kv head h / rep in place; f32
// or bf16 inputs widened to f32 on load; scores the product times
// 1/sqrt(hd) (the f32 reciprocal, as the card's plain form scales);
// masked scores NEG_INF = -1e30; f32 statistics.  The output o (B, S, H,
// hd) and the log-sum-exp of each row lse (B, H, S) leave in f32.  Where v
// is bf16 the probabilities are rounded to bf16 before their product with
// v, as the plain and flash forms round them.
//
// Products: mma.sync m16n8k8 TF32 with each f32 operand split into hi =
// tf32(a) and lo = tf32(a - hi); a product is hi hi + (lo hi + hi lo), the
// hi products and the corrections in separate accumulators folded in f32
// (the tensor cores truncate; kernel C does the same, ssd_tf32.cuh).  A
// product over the kv (or q) positions starts fresh on every tile and is
// folded into its f32 sum, so no chain of MMAs is longer than one tile.
// Single TF32 (about 3 decimal digits) is not used anywhere.
//
// Bound (the federated round's SmolLM-135M shape: B 48, S 2,048, 9 q and 3
// kv heads, hd 64, the causal half counted once): operations.  The
// forward's two products are 232 GFLOP, 3.46 ms at 67 TFLOP/s of f32 FMAs
// or 1.41 ms at 495 TFLOP/s with three TF32 products for each f32 one; it
// moves about 0.6 GB.  The backward's five products are 580 GFLOP (8.66
// and 3.52 ms).
//
// Design.  A warp owns 16 rows of a tile and runs its MMAs from shared
// memory.  The tiles a warp reads as the B operand (the kv tiles of the
// forward and of dQ, the q and dO tiles of dK and dV) are split into hi
// and lo once per CTA, as they arrive, and kept so; the rows a warp reads
// as the A operand (its own q, dO, k or v rows) stay raw f32 and are split
// a fragment at a time, once for every 8 n tiles.  Every tile has a pitch
// of hd + 4 floats, so that both fragment patterns below read 32 distinct
// banks.  The next tile's raw rows are copied (cp.async, f32) while this
// one is computed.  The score accumulator becomes the A operand of the
// next product in registers: its columns 2t and 2t + 1 of a block of 8
// are the product's k slots t and t + 4, and the B operand's rows are
// read in that order.
// * attn_fwd, one CTA per (16 W q rows, q head, batch row), the heaviest
//   rows first: S = Q Kt, the online softmax, O += P V.
// * The backward is two launches, no float atomics (the same bits run to
//   run), two products more than the five it needs, which an atomic sum
//   of dQ would save:
//   - attn_bwd_dq, one CTA per (q rows, q head, batch row): D = rowsum(dO
//     o O) (written for the next launch), then per kv tile P = exp(S -
//     lse), dP = dO Vt, dS = P o (dP - D) / sqrt(hd), dQ += dS K;
//   - attn_bwd_dkdv, one CTA per (16 W kv rows, kv head, batch row), over
//     the rep q heads it serves and the q tiles at and below the
//     diagonal: St = K Qt, Pt, dV += Pt dO, dPt = V dOt, dSt, dK += dSt Q.
//   dK and dV of a kv head are summed over its q heads in the CTA, so GQA
//   needs no repeated k or v and no reduction across CTAs.
// Tiles follow the head dim: W = 8 warps and kv (or q) tiles of 64 up to
// hd 64; at hd 128 W = 4 and tiles of 32, so that a CTA's tiles fit
// shared memory and a warp's accumulators its registers.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "ssd_tf32.cuh"  // split, put4, cp_async, widen4

namespace {

constexpr float kNegInf = -1e30f;

// tile shapes by head dim
template <int HD>
struct Shape {
  static constexpr int W = HD <= 64 ? 8 : 4;        // warps of a CTA
  static constexpr int THREADS = 32 * W;
  static constexpr int ROWS = 16 * W;               // rows a CTA owns
  static constexpr int P = HD + 4;                  // shared-memory pitch
  static constexpr int BN = HD <= 64 ? 64 : 32;     // kv (or q) tile
  static constexpr int NCH = HD / 8 < 8 ? HD / 8 : 8;   // n tiles a pass
  static constexpr int NCH_KV = HD <= 64 ? HD / 8 : 4;  // in attn_bwd_dkdv
};

// A tile split into hi and lo halves, each BN x P floats
struct Split {
  const float* hi;
  const float* lo;
};

// d += a b: one m16n8k8 TF32 MMA of a warp, f32 accumulators
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the three MMAs of a split product: hh += ah bh, lo += al bh + ah bl
__device__ __forceinline__ void mma3(float (&hh)[4], float (&lo)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const float* bh, const float* bl,
                                     int i0, int i1) {
  const uint32_t h0 = __float_as_uint(bh[i0]), h1 = __float_as_uint(bh[i1]);
  mma8(lo, al, h0, h1);
  mma8(lo, ah, __float_as_uint(bl[i0]), __float_as_uint(bl[i1]));
  mma8(hh, ah, h0, h1);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// c = A Bt for a warp's 16 rows: A's raw rows at `a`, 8 NT rows of the
// split B at `b`, both HD floats long at pitch HD + 4.  c in the
// accumulator layout: c[j] holds (row g, columns 8j + 2t, 8j + 2t + 1)
// and (row g + 8, the same columns), g = lane / 4, t = lane % 4.
template <int HD, int NT>
__device__ __forceinline__ void prod_rows(const float* a, Split b,
                                          float (&c)[NT][4]) {
  constexpr int P = Shape<HD>::P;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float hh[NT][4], lo[NT][4];
  zero_acc(hh);
  zero_acc(lo);
  const float* a0 = a + g * P + t;
  const int b0 = g * P + t;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[4], al[4];
    split(a0[kk], ah[0], al[0]);
    split(a0[8 * P + kk], ah[1], al[1]);
    split(a0[kk + 4], ah[2], al[2]);
    split(a0[8 * P + kk + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int i = b0 + 8 * j * P + kk;
      mma3(hh[j], lo[j], ah, al, b.hi, b.lo, i, i + 4);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = hh[j][e] + lo[j][e];
}

// c = p B for a warp's 16 rows: p (16 x 8 NC) in the accumulator layout,
// the split B's 8 NC rows (pitch P), its columns [n0, n0 + 8 NN).  The k
// slots t and t + 4 of p's block kc are its columns 8 kc + 2t and 8 kc +
// 2t + 1, so B's rows are read in that order.
template <int P, int NC, int NN>
__device__ __forceinline__ void prod_regs(const float (&p)[NC][4], Split b,
                                          int n0, float (&c)[NN][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float hh[NN][4], lo[NN][4];
  zero_acc(hh);
  zero_acc(lo);
  const int b0 = 2 * t * P + 8 * n0 + g;
#pragma unroll
  for (int kc = 0; kc < NC; ++kc) {
    uint32_t ah[4], al[4];
    split(p[kc][0], ah[0], al[0]);
    split(p[kc][2], ah[1], al[1]);
    split(p[kc][1], ah[2], al[2]);
    split(p[kc][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int i = b0 + 8 * kc * P + 8 * n;
      mma3(hh[n], lo[n], ah, al, b.hi, b.lo, i, i + P);
    }
  }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = hh[n][e] + lo[n][e];
}

// acc[n] += p B over all HD columns, NN n tiles at a time
template <int HD, int NC, int NN>
__device__ __forceinline__ void add_prod_regs(const float (&p)[NC][4],
                                              Split b,
                                              float (&acc)[HD / 8][4]) {
#pragma unroll
  for (int n0 = 0; n0 < HD / 8; n0 += NN) {
    float c[NN][4];
    prod_regs<Shape<HD>::P, NC, NN>(p, b, n0, c);
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += c[n][e];
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) of a (.., S, .., HD) tensor at `src` (its row r
// at base + r * stride elements) to `dst` at pitch HD + 4, widened to f32;
// rows at or past S are zeros.  f32 rows go by cp.async (wait for them
// with the copy group), bf16 rows through registers.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          bool bf16, long long base,
                                          long long stride, int row0,
                                          int S) {
  constexpr int Q = HD / 4, P = Shape<HD>::P, T = Shape<HD>::THREADS;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * Q; i += T) {
    const int r = i / Q, c = 4 * (i % Q);
    const bool ok = row0 + r < S;
    const long long e = ok ? base + (long long)(row0 + r) * stride + c : 0;
    float* d = dst + r * P + c;
    if (bf16) {
      const float4 x =
          ok ? widen4(*reinterpret_cast<const uint2*>(
                   reinterpret_cast<const unsigned short*>(src) + e))
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(d) = x;
    } else {
      cp_async<16>(d, reinterpret_cast<const float*>(src) + e, ok);
    }
  }
}

// the raw rows at `raw` (ROWS x (HD + 4)) split into hi and lo, at the
// same places
template <int HD, int ROWS>
__device__ __forceinline__ void split_rows(const float* raw, float* hi,
                                           float* lo) {
  constexpr int Q = HD / 4, P = Shape<HD>::P, T = Shape<HD>::THREADS;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * Q; i += T) {
    const int at = (i / Q) * P + 4 * (i % Q);
    put4(hi, lo, at, *reinterpret_cast<const float4*>(raw + at));
  }
}

// round to bf16 and back (nearest, even), for the product with a bf16 v
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Dims {
  int S, H, G;
  float scale;      // 1/sqrt(hd) in f32
  bool bf16;        // q, k, v in bf16 (else f32)
};

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
    attn_fwd(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, Dims d) {
  using Sh = Shape<HD>;
  constexpr int P = Sh::P, BN = Sh::BN, NT = BN / 8, ROWS = Sh::ROWS;
  constexpr int T = BN * P;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // ROWS x P, raw
  float* kraw = sq + ROWS * P;                    // the next k and v tiles
  float* vraw = kraw + T;
  float* kh = vraw + T;                           // this tile, split
  float* kl = kh + T;
  float* vh = kl + T;
  float* vl = vh + T;
  const int S = d.S, H = d.H, G = d.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / G);
  const long long qstride = (long long)H * HD, kstride = (long long)G * HD;
  const long long qbase = (long long)b * S * qstride + (long long)h * HD;
  const long long kbase = (long long)b * S * kstride + (long long)kvh * HD;
  const int tiles = (min(q0 + ROWS, S) + BN - 1) / BN;
  load_rows<HD, ROWS>(sq, q, d.bf16, qbase, qstride, q0, S);
  load_rows<HD, BN>(kraw, k, d.bf16, kbase, kstride, 0, S);
  load_rows<HD, BN>(vraw, v, d.bf16, kbase, kstride, 0, S);
  cp_commit();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * w;              // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[HD / 8][4];
  zero_acc(acc);

  for (int it = 0; it < tiles; ++it) {
    cp_wait_all();
    __syncthreads();               // tile it has landed; tile it-1 is done
    split_rows<HD, BN>(kraw, kh, kl);
    split_rows<HD, BN>(vraw, vh, vl);
    __syncthreads();
    if (it + 1 < tiles) {
      load_rows<HD, BN>(kraw, k, d.bf16, kbase, kstride, (it + 1) * BN, S);
      load_rows<HD, BN>(vraw, v, d.bf16, kbase, kstride, (it + 1) * BN, S);
    }
    cp_commit();
    const int kv0 = it * BN;
    if (kv0 > wrow + 15) continue;     // every column past the warp's rows
    float s[NT][4];
    prod_rows<HD, NT>(sq + 16 * w * P, Split{kh, kl}, s);
    const bool diag = kv0 + BN - 1 > wrow;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= d.scale;
        const int col = kv0 + 8 * j + 2 * t + (e & 1);
        if (diag && col > (e < 2 ? r0 : r1)) s[j][e] = kNegInf;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = expf(s[j][0] - m0);
      s[j][1] = expf(s[j][1] - m0);
      s[j][2] = expf(s[j][2] - m1);
      s[j][3] = expf(s[j][3] - m1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
    if (d.bf16) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = round_bf16(s[j][e]);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    add_prod_regs<HD, NT, Sh::NCH>(s, Split{vh, vl}, acc);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    const float l = half ? l1 : l0;
    float* out = o + qbase + (long long)r * qstride + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * half] / l, acc[n][2 * half + 1] / l);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * S + r] = (half ? m1 : m0) + logf(l);
    }
  }
}

// ---------------------------------------------------------------------
// backward, launch 1: D and dQ
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
    attn_bwd_dq(const void* __restrict__ q, const void* __restrict__ k,
                const void* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ dq, float* __restrict__ dsum, Dims d) {
  using Sh = Shape<HD>;
  constexpr int P = Sh::P, BN = Sh::BN, NT = BN / 8, ROWS = Sh::ROWS;
  constexpr int T = BN * P;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);   // ROWS x P, raw
  float* sdo = sq + ROWS * P;                     // ROWS x P, raw
  float* kraw = sdo + ROWS * P;                   // the next k and v tiles
  float* vraw = kraw + T;
  float* kh = vraw + T;                           // this tile, split
  float* kl = kh + T;
  float* vh = kl + T;
  float* vl = vh + T;
  const int S = d.S, H = d.H, G = d.G;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / G);
  const long long qstride = (long long)H * HD, kstride = (long long)G * HD;
  const long long qbase = (long long)b * S * qstride + (long long)h * HD;
  const long long kbase = (long long)b * S * kstride + (long long)kvh * HD;
  const long long sbase = ((long long)b * H + h) * S;
  const int tiles = (min(q0 + ROWS, S) + BN - 1) / BN;
  load_rows<HD, ROWS>(sq, q, d.bf16, qbase, qstride, q0, S);
  load_rows<HD, ROWS>(sdo, dout, false, qbase, qstride, q0, S);
  load_rows<HD, BN>(kraw, k, d.bf16, kbase, kstride, 0, S);
  load_rows<HD, BN>(vraw, v, d.bf16, kbase, kstride, 0, S);
  cp_commit();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * w;
  const int r0 = wrow + g, r1 = r0 + 8;
  // D = rowsum(dO o O) of the warp's rows, from device memory
  float dd0 = 0.0f, dd1 = 0.0f;
  for (int i = 0; i < 16; ++i) {
    const int r = wrow + i;
    float x = 0.0f;
    if (r < S) {
      const long long e = qbase + (long long)r * qstride;
#pragma unroll
      for (int c = lane; c < HD; c += 32) x += dout[e + c] * o[e + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (r < S && lane == 0) dsum[sbase + r] = x;
    if (i == g) dd0 = x;
    if (i == g + 8) dd1 = x;
  }
  const float ls0 = r0 < S ? lse[sbase + r0] : 0.0f;
  const float ls1 = r1 < S ? lse[sbase + r1] : 0.0f;
  float acc[HD / 8][4];
  zero_acc(acc);

  for (int it = 0; it < tiles; ++it) {
    cp_wait_all();
    __syncthreads();
    split_rows<HD, BN>(kraw, kh, kl);
    split_rows<HD, BN>(vraw, vh, vl);
    __syncthreads();
    if (it + 1 < tiles) {
      load_rows<HD, BN>(kraw, k, d.bf16, kbase, kstride, (it + 1) * BN, S);
      load_rows<HD, BN>(vraw, v, d.bf16, kbase, kstride, (it + 1) * BN, S);
    }
    cp_commit();
    const int kv0 = it * BN;
    if (kv0 > wrow + 15) continue;
    float p[NT][4], dp[NT][4];
    prod_rows<HD, NT>(sq + 16 * w * P, Split{kh, kl}, p);
    prod_rows<HD, NT>(sdo + 16 * w * P, Split{vh, vl}, dp);
    const bool diag = kv0 + BN - 1 > wrow;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 8 * j + 2 * t + (e & 1);
        const bool lower = e < 2;
        const float pe = (diag && col > (lower ? r0 : r1))
                             ? 0.0f
                             : expf(p[j][e] * d.scale - (lower ? ls0 : ls1));
        p[j][e] = pe * (dp[j][e] - (lower ? dd0 : dd1)) * d.scale;
      }
    add_prod_regs<HD, NT, Sh::NCH>(p, Split{kh, kl}, acc);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    float* out = dq + qbase + (long long)r * qstride + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// backward, launch 2: dK and dV
// ---------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
    attn_bwd_dkdv(const void* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, float* __restrict__ dk,
                  float* __restrict__ dv, Dims d) {
  using Sh = Shape<HD>;
  constexpr int P = Sh::P, BM = Sh::BN, NT = BM / 8, ROWS = Sh::ROWS;
  constexpr int T = BM * P, TH = Sh::THREADS;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);   // ROWS x P, raw
  float* sv = sk + ROWS * P;                      // ROWS x P, raw
  float* qraw = sv + ROWS * P;                    // the next q and dO tiles
  float* draw = qraw + T;
  float* qh = draw + T;                           // this tile, split
  float* ql = qh + T;
  float* doh = ql + T;
  float* dol = doh + T;
  float* sl = dol + T;                            // 2 x BM: lse
  float* sd = sl + 2 * BM;                        // 2 x BM: D
  const int S = d.S, H = d.H, G = d.G, rep = H / G;
  const int kv0 = blockIdx.x * ROWS;     // the heaviest (first) rows first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const long long qstride = (long long)H * HD, kstride = (long long)G * HD;
  const long long kbase = (long long)b * S * kstride + (long long)kvh * HD;
  const int nq = (S + BM - 1) / BM, qt0 = kv0 / BM, per = nq - qt0;
  const int steps = rep * per;
  load_rows<HD, ROWS>(sk, k, d.bf16, kbase, kstride, kv0, S);
  load_rows<HD, ROWS>(sv, v, d.bf16, kbase, kstride, kv0, S);

  // step i: q head kvh rep + i / per, q tile qt0 + i % per
  auto load_step = [&](int i) {
    const int hq = kvh * rep + i / per, qs = (qt0 + i % per) * BM;
    const long long qbase =
        (long long)b * S * qstride + (long long)hq * HD;
    load_rows<HD, BM>(qraw, q, d.bf16, qbase, qstride, qs, S);
    load_rows<HD, BM>(draw, dout, false, qbase, qstride, qs, S);
    const long long sb = ((long long)b * H + hq) * S;
    const int buf = (i & 1) * BM;
    for (int j = threadIdx.x; j < BM; j += TH) {
      const bool ok = qs + j < S;
      sl[buf + j] = ok ? lse[sb + qs + j] : 0.0f;
      sd[buf + j] = ok ? dsum[sb + qs + j] : 0.0f;
    }
  };
  load_step(0);
  cp_commit();

  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = kv0 + 16 * w;            // the warp's first kv row
  const int r0 = wrow + g, r1 = r0 + 8;
  float ak[HD / 8][4], av[HD / 8][4];
  zero_acc(ak);
  zero_acc(av);

  for (int it = 0; it < steps; ++it) {
    cp_wait_all();
    __syncthreads();
    split_rows<HD, BM>(qraw, qh, ql);
    split_rows<HD, BM>(draw, doh, dol);
    __syncthreads();
    if (it + 1 < steps) load_step(it + 1);
    cp_commit();
    const int qs = (qt0 + it % per) * BM;
    if (qs + BM - 1 < wrow) continue;   // every q before the warp's kv rows
    const Split qt{qh, ql}, dot{doh, dol};
    const float* lt = sl + (it & 1) * BM;
    const float* dt = sd + (it & 1) * BM;
    float p[NT][4], dp[NT][4];
    prod_rows<HD, NT>(sk + 16 * w * P, qt, p);
    const bool edge = qs < wrow + 15 || qs + BM > S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), col = qs + c;
        const bool off = edge && (col < (e < 2 ? r0 : r1) || col >= S);
        p[j][e] = off ? 0.0f : expf(p[j][e] * d.scale - lt[c]);
      }
    if (d.bf16) {       // dV takes the probabilities as the forward's
      float pr[NT][4];  // product with v did
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pr[j][e] = round_bf16(p[j][e]);
      add_prod_regs<HD, NT, Sh::NCH_KV>(pr, dot, av);
    } else {
      add_prod_regs<HD, NT, Sh::NCH_KV>(p, dot, av);
    }
    prod_rows<HD, NT>(sv + 16 * w * P, dot, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        p[j][e] = p[j][e] * (dp[j][e] - dt[c]) * d.scale;
      }
    add_prod_regs<HD, NT, Sh::NCH_KV>(p, qt, ak);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= S) continue;
    const long long e = kbase + (long long)r * kstride + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<float2*>(dk + e + 8 * n) =
          make_float2(ak[n][2 * half], ak[n][2 * half + 1]);
      *reinterpret_cast<float2*>(dv + e + 8 * n) =
          make_float2(av[n][2 * half], av[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------
// shared memory: the CTA's own raw rows (one or two blocks of ROWS), a
// raw pair of tiles in flight and the same pair split (6 tiles), and
// attn_bwd_dkdv's lse and D of two steps
template <int HD>
constexpr int smem_bytes(int own) {
  using Sh = Shape<HD>;
  return 4 * ((own * Sh::ROWS + 6 * Sh::BN) * Sh::P);
}

template <int HD>
cudaError_t configure() {
  static const cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<HD>(1));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dq<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<HD>(2));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_dkdv<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<HD>(2) + 16 * Shape<HD>::BN);
    return e;
  }();
  return status;
}

template <int HD>
int run_fwd(const long long* a, cudaStream_t st, int B, const Dims& d) {
  using Sh = Shape<HD>;
  const cudaError_t e = configure<HD>();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((d.S + Sh::ROWS - 1) / Sh::ROWS, d.H, B);
  attn_fwd<HD><<<grid, Sh::THREADS, smem_bytes<HD>(1), st>>>(
      reinterpret_cast<const void*>(a[0]), reinterpret_cast<const void*>(a[1]),
      reinterpret_cast<const void*>(a[2]), reinterpret_cast<float*>(a[3]),
      reinterpret_cast<float*>(a[4]), d);
  return (int)cudaGetLastError();
}

template <int HD>
int run_bwd(const long long* a, cudaStream_t st, int B, const Dims& d) {
  using Sh = Shape<HD>;
  const cudaError_t e = configure<HD>();
  if (e != cudaSuccess) return (int)e;
  auto f = [&](int i) { return reinterpret_cast<float*>(a[i]); };
  auto c = [&](int i) { return reinterpret_cast<const void*>(a[i]); };
  const int blocks = (d.S + Sh::ROWS - 1) / Sh::ROWS;
  attn_bwd_dq<HD><<<dim3(blocks, d.H, B), Sh::THREADS, smem_bytes<HD>(2),
                    st>>>(c(0), c(1), c(2), f(3), f(4), f(5), f(6), f(9), d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<HD><<<dim3(blocks, d.G, B), Sh::THREADS,
                      smem_bytes<HD>(2) + 16 * Sh::BN, st>>>(
      c(0), c(1), c(2), f(4), f(5), f(9), f(7), f(8), d);
  return (int)cudaGetLastError();
}

// the arguments after the pointers and the stream: B, S, H, G, hd, bf16,
// the bits of the f32 scale
bool parse(const long long* a, int& B, int& hd, Dims& d) {
  B = (int)a[0];
  d.S = (int)a[1];
  d.H = (int)a[2];
  d.G = (int)a[3];
  hd = (int)a[4];
  d.bf16 = a[5] != 0;
  const uint32_t bits = (uint32_t)a[6];
  memcpy(&d.scale, &bits, 4);
  return B >= 0 && d.S >= 0 && d.G >= 1 && d.H >= d.G && d.H % d.G == 0 &&
         B <= 65535 && d.H <= 65535;
}

}  // namespace

extern "C" {

// Causal self-attention, forward.  `a` holds 13 64-bit values
// (kernels/attention.py packs them): the device addresses of q (B, S, H,
// hd), k and v (B, S, G, hd) (all f32, or all bf16), of the outputs o (B,
// S, H, hd) and lse (B, H, S) (f32), the stream; then B, S, H, G, hd
// (16, 32, 48, 64 or 128), bf16 (0 or 1) and the bits of the f32 scale.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
int attn_fwd_run(const long long* a) {
  int B, hd;
  Dims d;
  if (!parse(a + 6, B, hd, d)) return (int)cudaErrorInvalidValue;
  if (B == 0 || d.S == 0) return (int)cudaGetLastError();
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(a[5]);
  switch (hd) {
    case 16: return run_fwd<16>(a, st, B, d);
    case 32: return run_fwd<32>(a, st, B, d);
    case 48: return run_fwd<48>(a, st, B, d);
    case 64: return run_fwd<64>(a, st, B, d);
    case 128: return run_fwd<128>(a, st, B, d);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Causal self-attention, backward.  `a` holds 18 64-bit values: the device
// addresses of q, k, v (as for the forward), o, dO (B, S, H, hd) and lse
// (B, H, S) (f32), of the outputs dq (B, S, H, hd), dk and dv (B, S, G,
// hd) (f32), of the workspace D (B, H, S) (f32), the stream; then B, S,
// H, G, hd, bf16 and the bits of the f32 scale.  Two launches.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels
// do not take.
int attn_bwd_run(const long long* a) {
  int B, hd;
  Dims d;
  if (!parse(a + 11, B, hd, d)) return (int)cudaErrorInvalidValue;
  if (B == 0 || d.S == 0) return (int)cudaGetLastError();
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(a[10]);
  switch (hd) {
    case 16: return run_bwd<16>(a, st, B, d);
    case 32: return run_bwd<32>(a, st, B, d);
    case 48: return run_bwd<48>(a, st, B, d);
    case 64: return run_bwd<64>(a, st, B, d);
    case 128: return run_bwd<128>(a, st, B, d);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
