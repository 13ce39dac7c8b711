// ssd_scan.cu -- the Mamba2 SSD intra-chunk step (kernel C).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_chunk (the pallas_call
// at :58, body _kernel :22) of the JAX package.
//
// What it computes, per cell g (one batch row, chunk and head; cells
// ordered (batch, chunk, head)), with f32 accumulation:
//   CB = C Bt                                    (L x L)
//   y  = (CB o exp(cum_i - cum_j) [i >= j]) Xb    (L x P)
//   S  = (B o exp(cum[L-1] - cum))t Xb            (N x P)
//   a  = exp(cum[L-1])
// Xb is (G, L, P) f32, cum (G, 1, L) f32; B and C are (G / heads, L, N) in
// f32 or bf16, one copy per (batch, chunk) serving all `heads` cells of it
// (cell g reads row g / heads); bf16 is widened exactly.
//
// What bounds it on an H100: at the admission shape (one 512-token prompt
// of Mamba2-370M: 2 (batch, chunk) groups x 32 heads, L=256, P=64, N=128)
// the function needs 555 MFLOP -- C Bt once per (batch, chunk) on the
// causal triangle, the masked product on the triangle, the state -- and
// moves 11.1 MB.  That is 8.28 us at the 67 TFLOP/s f32 rate outside the
// tensor cores, 1.12 us at 495 TFLOP/s TF32, and 3.31 us of bytes at
// 3.35 TB/s: on the tensor cores the launch is bound by its bytes.
//
// What the design does about it:
// * All three products run on the tensor cores as warpgroup MMAs
//   (wgmma m64n64k8 tf32, f32 accumulators) with split TF32: each f32
//   operand is hi = tf32(a), lo = tf32(a - hi), and a product is
//   lo*hi + hi*lo + hi*hi.  That keeps about 21 bits of each operand
//   (1xTF32 keeps 11 and misses the f32 tolerances by far), for three
//   times the tensor work: 1.67 GFLOP, 3.4 us at 495 TFLOP/s, about the
//   byte bound.
// * C Bt once per (batch, chunk, row tile) per head group, not per head:
//   one CTA owns a 64-row tile of y for a head group of 2 heads of one
//   (batch, chunk) and walks the 64-column tiles at or below the diagonal.
//   Its 256 threads copy and split the operands together; its two
//   warpgroups form the two 32-column halves of the score tile C_i B_jt,
//   which meet in shared memory, and then each forms the tile of y of its
//   own head.  A head group, not one CTA for all heads of a chunk and not
//   a cluster sharing the tile through distributed shared memory: a
//   512-token prompt has only 2 (batch, chunk) groups x 4 row tiles, so
//   the grid must split heads to fill 132 SMs; a group of 2 gives 128 y
//   CTAs at that shape and C Bt 16 times per chunk instead of 32.  (At one
//   warpgroup per CTA the kernel ran 1.5x slower: with 4 warps per SM
//   nothing hid the latencies of the copies and splits.)
// * The mask sits in the exponent: a term above the diagonal is zero
//   before its exp, so the positive log-decay is never exponentiated;
//   tiles above the diagonal are skipped.  The scores leave the C Bt
//   accumulators in registers and feed the y product as its register A
//   operand: the K order inside each 8-column step is permuted (slot t
//   holds column 2t, slot t+4 column 2t+1) to match the accumulator
//   layout, and the Xb tile is stored with the same permutation.
// * The tensor cores accumulate with truncation, and on inputs of unit
//   scale a 64-long sum then drifts past the 1e-5 tolerance.  So the hi*hi
//   products and the two correction products go to separate accumulators,
//   each fresh for one 64-wide tile of the sum, and the tile's share is
//   added to the running sum in f32 with round to nearest.
// * The state S = Bt (d o Xb) (d = exp(cum[L-1] - cum)) is a wgmma too:
//   B is transposed on its way into shared memory (TF32 wgmma takes both
//   operands K-major) and Xb is scaled by d there.  One CTA per cell forms
//   S and a, each warpgroup one 64-row half of S.
// * Operands reach shared memory by cp.async, with no register on the
//   way: f32 rows of b and c straight into their places; Xb (and B for S)
//   as raw rows, then transposed in 4 x 4 blocks through registers; bf16
//   rows staged and widened.  The hi/lo split runs over shared memory.
//   The operands use the no-swizzle K-major layout of 8 x 16-byte core
//   matrices, the transposed ones with a 16-byte pad per 4 columns so
//   their stores do not conflict, and zero padding covers ragged L, N and
//   P, so every shape the wrapper takes runs: L from 1 to 256, P and N
//   multiples of 4 up to 64 and 128, any head count.  The longest CTAs
//   (the bottom two row tiles, then the state CTAs) launch first.
//
// What still bounds it: the bytes into each SM, not the tensor cores.  A
// CTA of the bottom row tile copies 288 KB, one CTA per SM (215 KB of
// shared memory each), and its copies, splits and products run one after
// another; overlapping the next column tile's copies with this one's
// products needs a second set of buffers that does not fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows of y per CTA; columns per step
constexpr int kThreads = 256;        // two warpgroups
constexpr int kHeadGroup = 2;        // heads per CTA, one per warpgroup
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 128;

// An operand of R rows (the M or N side of the MMA) by K columns in the
// no-swizzle K-major layout: core matrices of 8 rows x 4 floats, 128
// contiguous bytes each; the 8-row groups of one 4-column group follow each
// other (SBO = 128 bytes), and the next 4 columns start `gs` floats later
// (LBO = 4 gs bytes).  gs is R * 4, or R * 4 + 4 for operands stored
// transposed: the padding puts the 4-column groups of one row on distinct
// banks, so 8 threads storing 16 bytes each to 8 groups do not conflict.
__device__ __forceinline__ int op_index(int gs, int r, int k) {
  return (k >> 2) * gs + (r >> 3) * 32 + (r & 7) * 4 + (k & 3);
}

// shared-memory matrix descriptor of an operand that starts at `p`
__device__ __forceinline__ uint64_t op_desc(const float* p, int gs) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(gs >> 2) << 16) |            // LBO: next 4 columns
         ((uint64_t)(128 >> 4) << 32);            // SBO: next 8 rows
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// split x into hi and lo TF32 parts (as f32 bit patterns)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// hi and lo parts of 4 values to 16 bytes each at hi + i and lo + i
__device__ __forceinline__ void put4(float* hi, float* lo, int i, float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + i) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
}

// d = A B (+ d when `acc`), m64n64k8, A and B from shared memory
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d = A B (+ d when `acc`), m64n32k8, A and B from shared memory
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d = A B (+ d when `acc`), m64n64k8, A from registers (this thread's 4
// values), B from shared memory
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void mma_wait() {
  mma_commit();
  mma_wait_all();
}
// make this thread's shared-memory stores visible to the MMA unit, then
// wait for every thread's
__device__ __forceinline__ void publish() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
}

// d += hh + corr, in f32 with round to nearest
__device__ __forceinline__ void fold(float (&d)[32], const float (&hh)[32],
                                     const float (&corr)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += hh[i] + corr[i];
}

// Asynchronous copy of kBytes from device to shared memory; an element
// outside the matrix (valid false) reads nothing and lands as zeros.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  }
}

// every copy this thread started has landed, then every thread's has
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// four bf16 values widened to f32: bf16 is the high half of an f32, so
// widening is a shift, exact
__device__ __forceinline__ float4 widen4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// The loaders come in pairs: copy_* starts asynchronous copies of raw
// values, straight to their final places in the lo half of an operand where
// they are f32, or in rows to `stage` where they are bf16; after
// cp_async_wait, split_* turns them into the hi and lo halves.  No value
// passes through registers on its way from device memory, so every copy of
// a phase is in flight at once.

// The loops below are unrolled and read everything before they write, so
// that a thread keeps many copies, loads and conversions in flight: a CTA
// holds the whole of an SM's shared memory, so its 8 warps (two per
// scheduler) are all there is to hide a latency behind.

// item i of a 64 x 128 tile in 4-value pieces (r, q), 8 threads per core
// matrix; 16 items per thread
constexpr int kRowItems = kTile * (kMaxN / 4) / kThreads;
__device__ __forceinline__ void rows_item(int i, int& r, int& q) {
  r = (i & 7) + (i >> 8) * 8;
  q = (i >> 3) & 31;
}

// rows [row0, row0 + 64) of an (L, N) b or c matrix, for a 64-row,
// 128-column operand (rows past L and columns past N zero)
template <bool kBf16>
__device__ void copy_rows(const void* src, long long base, int row0, int L,
                          int N, float* lo, unsigned short* stage) {
#pragma unroll
  for (int u = 0; u < kRowItems; ++u) {
    int r, q;
    rows_item(threadIdx.x + u * kThreads, r, q);
    const bool ok = row0 + r < L && 4 * q < N;
    const long long e = ok ? base + (long long)(row0 + r) * N + 4 * q : 0;
    if (kBf16) {
      cp_async<8>(stage + r * kMaxN + 4 * q,
                  reinterpret_cast<const unsigned short*>(src) + e, ok);
    } else {
      cp_async<16>(lo + op_index(kTile * 4, r, 4 * q),
                   reinterpret_cast<const float*>(src) + e, ok);
    }
  }
}

template <bool kBf16>
__device__ void split_rows(float* hi, float* lo,
                           const unsigned short* stage) {
  float4 v[kRowItems];
#pragma unroll
  for (int u = 0; u < kRowItems; ++u) {
    int r, q;
    rows_item(threadIdx.x + u * kThreads, r, q);
    v[u] = kBf16 ? widen4(*reinterpret_cast<const uint2*>(
                       stage + r * kMaxN + 4 * q))
                 : *reinterpret_cast<const float4*>(
                       lo + op_index(kTile * 4, r, 4 * q));
  }
#pragma unroll
  for (int u = 0; u < kRowItems; ++u) {
    int r, q;
    rows_item(threadIdx.x + u * kThreads, r, q);
    put4(hi, lo, op_index(kTile * 4, r, 4 * q), v[u]);
  }
}

// rows [row0, row0 + 64) of an (L, W) f32 matrix (W <= 4 kQuads), as
// they are, to `raw` with a row pitch of 4 kQuads + 4 floats (zero past L
// and W); split_t then transposes them
template <int kQuads>
__device__ void copy_raw(const float* __restrict__ src, int row0, int L,
                         int W, float* raw) {
  constexpr int kPitch = 4 * kQuads + 4, kPer = kTile * kQuads / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int l = i / kQuads, q = i % kQuads;
    const bool ok = row0 + l < L && 4 * q < W;
    cp_async<16>(raw + l * kPitch + 4 * q,
                 src + (ok ? (long long)(row0 + l) * W + 4 * q : 0), ok);
  }
}

// 64 rows of 4 kQuads values, read as raw4(l, q) (4 values from quad q of
// row l), transposed into a 4 kQuads-row by 64-column (position) operand
// with group stride 16 kQuads + 4, each value times scale[l] when `scale`
// is given.  With `permute` the 8 positions of a step sit in the order the
// y product's register operand uses (slot t <- position 2t, slot t+4 <-
// 2t+1).  A thread moves blocks of 4 positions x 4 columns: it reads them
// all, waits for every thread to have read (the raw rows may lie where the
// operand goes), and writes 16 bytes per column; the 8 threads of a store
// phase write 8 column groups, on distinct banks thanks to the padding.
template <int kQuads, typename Raw>
__device__ void split_t(const Raw& raw4, const float* scale, bool permute,
                        float* hi, float* lo) {
  constexpr int kGs = 16 * kQuads + 4, kPer = 16 * kQuads / kThreads;
  float4 v[kPer][4];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int kb = i & 15, m = i >> 4;             // 4 positions, quad
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = permute ? 8 * (kb >> 1) + (kb & 1) + 2 * e : 4 * kb + e;
      v[u][e] = raw4(l, m);
      if (scale != nullptr) {
        const float sc = scale[l];
        v[u][e] = make_float4(v[u][e].x * sc, v[u][e].y * sc,
                              v[u][e].z * sc, v[u][e].w * sc);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int kb = i & 15, m = i >> 4;
    const float4* x = v[u];
    put4(hi, lo, op_index(kGs, 4 * m, 4 * kb),
         make_float4(x[0].x, x[1].x, x[2].x, x[3].x));
    put4(hi, lo, op_index(kGs, 4 * m + 1, 4 * kb),
         make_float4(x[0].y, x[1].y, x[2].y, x[3].y));
    put4(hi, lo, op_index(kGs, 4 * m + 2, 4 * kb),
         make_float4(x[0].z, x[1].z, x[2].z, x[3].z));
    put4(hi, lo, op_index(kGs, 4 * m + 3, 4 * kb),
         make_float4(x[0].w, x[1].w, x[2].w, x[3].w));
  }
}

// cum[pos0, pos0 + 64) of the cells [g0, g0 + nh) to dst[h][64] (zero
// past L and past the last head)
__device__ void copy_cum(const float* __restrict__ cum, int g0, int nh,
                         int L, int pos0, float* dst) {
  for (int i = threadIdx.x; i < kHeadGroup * kTile; i += kThreads) {
    const int h = i / kTile, k = i - h * kTile;
    const bool ok = h < nh && pos0 + k < L;
    cp_async<4>(dst + i, cum + (ok ? (long long)(g0 + h) * L + pos0 + k : 0),
                ok);
  }
}

// raw4 of f32 rows that copy_raw<kQuads> left at `raw`
template <int kQuads>
struct RawRows {
  const float* raw;
  __device__ float4 operator()(int l, int q) const {
    return *reinterpret_cast<const float4*>(raw + l * (4 * kQuads + 4) +
                                            4 * q);
  }
};

// raw4 of bf16 rows that copy_rows<true> left at `stage`, widened
struct StagedRows {
  const unsigned short* stage;
  __device__ float4 operator()(int l, int q) const {
    return widen4(*reinterpret_cast<const uint2*>(stage + l * kMaxN + 4 * q));
  }
};

struct Args {
  const float* xb;
  const void* b;
  const void* c;
  const float* cum;
  int G, heads, L, P, N, groups_per_chunk;
  float* y;
  float* s;
  float* a;
};

// shared memory, in floats
constexpr int kOpBig = kTile * kMaxN;          // 64 x 128 operand
constexpr int kGsX = kMaxP * 4 + 4;            // group stride of Xb^T
constexpr int kGsB = kMaxN * 4 + 4;            // of B^T
constexpr int kOpX = (kTile / 4) * kGsX;        // 64 x 64 operand, padded
constexpr int kOpBt = (kTile / 4) * kGsB;       // 128 x 64 operand, padded
constexpr int kStage = kTile * kMaxN / 2;       // 64 x 128 bf16
constexpr int kSmemFloats =
    4 * kOpBig + 2 * kHeadGroup * kOpX + 2 * kHeadGroup * kTile + kStage;

// One 64-row tile of y for the heads [h0, h0 + nh) of (batch, chunk) gbi.
// All threads copy and split the operands; warpgroup w then forms the
// score tile in its registers and the tile of y of head h0 + w.
template <bool kBf16>
__device__ void y_tile(const Args& A, int gbi, int h0, int nh, int tile,
                       float* sm) {
  float* c_hi = sm;                  // C rows of the tile: 64 x 128
  float* c_lo = c_hi + kOpBig;
  float* b_hi = c_lo + kOpBig;       // B rows of the column tile
  float* b_lo = b_hi + kOpBig;
  float* xs = b_lo + kOpBig;         // [kHeadGroup][hi, lo]: Xb of the
                                     // column tile, transposed
  float* cr = xs + 2 * kHeadGroup * kOpX;  // [kHeadGroup][64]: cum of rows
  float* cc = cr + kHeadGroup * kTile;  // [kHeadGroup][64]: of the columns
  unsigned short* stage =            // bf16 b or c rows on their way in
      reinterpret_cast<unsigned short*>(cc + kHeadGroup * kTile);

  const int L = A.L, P = A.P, N = A.N;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;   // warpgroup, its warp
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = tile * kTile;
  const long long bc0 = (long long)gbi * L * N;
  const int g0 = gbi * A.heads + h0;   // first cell
  const bool mine = wg < nh;           // this warpgroup has a head
  const float* my_cr = cr + wg * kTile;
  const float* my_cc = cc + wg * kTile;
  const float* x_hi = xs + 2 * wg * kOpX;
  const float* x_lo = x_hi + kOpX;

  copy_rows<kBf16>(A.c, bc0, r0, L, N, c_lo, stage);
  copy_cum(A.cum, g0, nh, L, r0, cr);
  cp_async_wait();
  split_rows<kBf16>(c_hi, c_lo, stage);

  float yacc[32];
  zero(yacc);
  // this thread's two rows of the tile (accumulator layout)
  const int ra = 16 * warp + gq, rb = ra + 8;
  const float cra = my_cr[ra], crb = my_cr[rb];   // (cp_async_wait's
  const bool rowa = r0 + ra < L, rowb = r0 + rb < L;  // barrier published)

  for (int ct = 0; ct <= tile; ++ct) {
    const int c0 = ct * kTile;
    __syncthreads();                 // the last step is done with smem
    copy_rows<kBf16>(A.b, bc0, c0, L, N, b_lo, stage);
    for (int h = 0; h < nh; ++h) {
      copy_raw<kMaxP / 4>(A.xb + (long long)(g0 + h) * L * P, c0, L, P,
                          xs + 2 * h * kOpX);
    }
    copy_cum(A.cum, g0, nh, L, c0, cc);
    cp_async_wait();
    split_rows<kBf16>(b_hi, b_lo, stage);
    for (int h = 0; h < nh; ++h) {
      split_t<kMaxP / 4>(RawRows<kMaxP / 4>{xs + 2 * h * kOpX}, nullptr,
                         true, xs + 2 * h * kOpX, xs + (2 * h + 1) * kOpX);
    }
    publish();
    // score tile C_i B_ctt, split TF32 (hi*hi and the two correction
    // products in separate accumulators, added in f32 at the end), once
    // for the head group: warpgroup w forms its columns [32w, 32w + 32),
    // and the two halves meet in shared memory (the stage is free now), in
    // the layout of the 64 x 64 accumulator, slot-major.  The sum runs
    // over all 128 columns of the operands, zero past N: a loop of fixed
    // length is unrolled whole, where one that ends at N made ptxas
    // inject a warpgroup.arrive at its every turn (warning C7519)
    float* cb_s = reinterpret_cast<float*>(stage);
    const int t128 = tid & 127;
    {
      float half[16], corr[16];
      const int ob = wg * (32 / 8) * 32;          // B rows [32w, 32w + 32)
      mma_fence();
#pragma unroll
      for (int k = 0; k < kMaxN; k += 8) {
        const int o = (k >> 2) * (kTile * 4);
        const uint64_t ch = op_desc(c_hi + o, kTile * 4);
        const uint64_t cl = op_desc(c_lo + o, kTile * 4);
        const uint64_t bh = op_desc(b_hi + o + ob, kTile * 4);
        const uint64_t bl = op_desc(b_lo + o + ob, kTile * 4);
        mma_ss32(half, ch, bh, k > 0);
        mma_ss32(corr, cl, bh, k > 0);
        mma_ss32(corr, ch, bl, 1);
      }
      mma_wait();
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cb_s[(16 * wg + i) * 128 + t128] = half[i] + corr[i];
      }
    }
    __syncthreads();
    if (!mine) continue;
    float cb[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cb[i] = cb_s[i * 128 + t128];

    // this column tile's share of y, hi*hi and corrections apart, folded
    // into yacc in f32: the tensor cores' accumulation never runs over more
    // than one tile
    // the second half's scores are formed while the first half's MMAs run
    float yt[32], yc[32];
    uint32_t ahi[8][4], alo[8][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int q = 4 * half + qq;
        const int ka = 8 * q + 2 * tq, kb = ka + 1;   // columns of the tile
        const float cca = my_cc[ka], ccb = my_cc[kb];
        // the mask before the exp: c <= r, and r inside the chunk
        const float s0 = (rowa && c0 + ka <= r0 + ra)
                             ? cb[4 * q] * expf(cra - cca) : 0.0f;
        const float s1 = (rowa && c0 + kb <= r0 + ra)
                             ? cb[4 * q + 1] * expf(cra - ccb) : 0.0f;
        const float s2 = (rowb && c0 + ka <= r0 + rb)
                             ? cb[4 * q + 2] * expf(crb - cca) : 0.0f;
        const float s3 = (rowb && c0 + kb <= r0 + rb)
                             ? cb[4 * q + 3] * expf(crb - ccb) : 0.0f;
        // register A: (row ra, slot tq), (rb, tq), (ra, tq+4), (rb, tq+4)
        split(s0, ahi[q][0], alo[q][0]);
        split(s2, ahi[q][1], alo[q][1]);
        split(s1, ahi[q][2], alo[q][2]);
        split(s3, ahi[q][3], alo[q][3]);
      }
      mma_fence();
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int q = 4 * half + qq;
        const int o = 2 * q * kGsX;
        const uint64_t xh = op_desc(x_hi + o, kGsX);
        const uint64_t xl = op_desc(x_lo + o, kGsX);
        mma_rs(yt, ahi[q], xh, q > 0);
        mma_rs(yc, alo[q], xh, q > 0);
        mma_rs(yc, ahi[q], xl, 1);
      }
      mma_commit();
    }
    mma_wait_all();
    fold(yacc, yt, yc);
  }

  if (!mine) return;
  // accumulator (row 16w + gq [+8], column 8j + 2tq [+1])
  float* yg = A.y + (long long)(g0 + wg) * L * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * j + 2 * tq;
    if (p >= P) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = r0 + (e ? rb : ra);
      if (r < L) {
        *reinterpret_cast<float2*>(yg + (long long)r * P + p) =
            make_float2(yacc[4 * j + 2 * e], yacc[4 * j + 2 * e + 1]);
      }
    }
  }
}

// S (N x P) and a for cell g, of (batch, chunk) gbi.  All threads copy and
// split the operands; warpgroup w forms rows [64w, 64w + 64) of S.
template <bool kBf16>
__device__ void state_tile(const Args& A, int g, int gbi, float* sm) {
  float* bt_hi = sm;                 // B of the rows, transposed: 128 x 64
  float* bt_lo = bt_hi + kOpBt;
  float* x_hi = bt_lo + kOpBt;       // d o Xb of the rows, transposed
  float* x_lo = x_hi + kOpX;
  float* ds = x_lo + kOpX;           // [64]: exp(cum[L-1] - cum)
  unsigned short* stage =            // bf16 B rows on their way in
      reinterpret_cast<unsigned short*>(ds + kTile);

  const int L = A.L, P = A.P, N = A.N;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const long long bc0 = (long long)gbi * L * N;
  const float* cumg = A.cum + (long long)g * L;
  const bool mine = wg * kTile < N;  // this warpgroup's rows of S exist

  float acc[32];
  zero(acc);

  for (int l0 = 0; l0 < L; l0 += kTile) {
    __syncthreads();                 // the last chunk is done with smem
    if (tid < kTile) {
      ds[tid] = l0 + tid < L ? expf(cumg[L - 1] - cumg[l0 + tid]) : 0.0f;
    }
    // B rows [l0, l0 + 64), transposed into a 128-row (n) operand, and
    // d o Xb of the same rows
    if (kBf16) {
      copy_rows<true>(A.b, bc0, l0, L, N, nullptr, stage);
    } else {
      copy_raw<kMaxN / 4>(reinterpret_cast<const float*>(A.b) + bc0, l0, L,
                          N, bt_hi);
    }
    copy_raw<kMaxP / 4>(A.xb + (long long)g * L * P, l0, L, P, x_hi);
    cp_async_wait();
    if (kBf16) {
      split_t<kMaxN / 4>(StagedRows{stage}, nullptr, false, bt_hi, bt_lo);
    } else {
      split_t<kMaxN / 4>(RawRows<kMaxN / 4>{bt_hi}, nullptr, false, bt_hi,
                         bt_lo);
    }
    split_t<kMaxP / 4>(RawRows<kMaxP / 4>{x_hi}, ds, false, x_hi, x_lo);
    publish();
    if (!mine) continue;
    // this chunk's share, hi*hi and corrections apart, folded into acc in
    // f32
    float st[32], sc[32];
    mma_fence();
    for (int k = 0; k < kTile; k += 8) {
      const int oa = (k >> 2) * kGsB + wg * (kTile / 8) * 32;
      const int ob = (k >> 2) * kGsX;
      const uint64_t bh = op_desc(bt_hi + oa, kGsB);
      const uint64_t bl = op_desc(bt_lo + oa, kGsB);
      const uint64_t xh = op_desc(x_hi + ob, kGsX);
      const uint64_t xl = op_desc(x_lo + ob, kGsX);
      mma_ss(st, bh, xh, k > 0);
      mma_ss(sc, bl, xh, k > 0);
      mma_ss(sc, bh, xl, 1);
    }
    mma_wait();
    fold(acc, st, sc);
  }

  if (tid == 0) A.a[g] = expf(cumg[L - 1]);
  if (!mine) return;
  float* sg = A.s + (long long)g * N * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * j + 2 * tq;
    if (p >= P) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = wg * kTile + 16 * warp + gq + 8 * e;
      if (n < N) {
        *reinterpret_cast<float2*>(sg + (long long)n * P + p) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
      }
    }
  }
}

// CTAs, longest first: the y CTAs of the bottom two row tiles, the state
// CTAs (one per cell), then the other row tiles, bottom first.  A row tile
// has one y CTA per head group of each (batch, chunk).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args A) {
  extern __shared__ __align__(128) float sm[];
  const int per = A.groups_per_chunk;
  const int row = (A.G / A.heads) * per;        // y CTAs per row tile
  const int n_tiles = (A.L + kTile - 1) / kTile;
  const int first = min(n_tiles, 2) * row;      // y CTAs before the state
  int blk = blockIdx.x;
  if (blk >= first && blk < first + A.G) {
    const int g = blk - first;
    state_tile<kBf16>(A, g, g / A.heads, sm);
    return;
  }
  if (blk >= first) blk -= A.G;
  const int rank = blk / row, rem = blk - rank * row;
  const int gbi = rem / per, hg = rem - gbi * per;
  const int h0 = hg * kHeadGroup;
  y_tile<kBf16>(A, gbi, h0, min(kHeadGroup, A.heads - h0),
                n_tiles - 1 - rank, sm);
}

constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

// the dynamic shared memory every launch asks for, set once per process
cudaError_t configure_once() {
  static cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_scan_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemBytes);
  }();
  return status;
}

}  // namespace

extern "C" {

// Intra-chunk SSD over G cells on `stream`: xb (G, L, P) f32, b and c
// (G / heads, L, N) f32 (bc_bf16 = 0) or bf16 (bc_bf16 = 1), cum (G, 1, L)
// f32 -> y (G, L, P), s (G, N, P), a (G, 1), all f32.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take (L <= 256, P <= 64, N <= 128, P and N multiples of 4).
int ssd_scan_launch(const void* xb, const void* b, const void* c,
                    const void* cum, int bc_bf16, int G, int heads, int L,
                    int P, int N, void* y, void* s, void* a, void* stream) {
  if (L < 1 || L > kMaxL || P < 4 || P > kMaxP || P % 4 || N < 4 ||
      N > kMaxN || N % 4 || heads < 1 || G < 0 || G % heads) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  if (G > 0) {
    Args A;
    A.xb = reinterpret_cast<const float*>(xb);
    A.b = b;
    A.c = c;
    A.cum = reinterpret_cast<const float*>(cum);
    A.heads = heads;
    A.L = L;
    A.P = P;
    A.N = N;
    A.G = G;
    A.groups_per_chunk = (heads + kHeadGroup - 1) / kHeadGroup;
    A.y = reinterpret_cast<float*>(y);
    A.s = reinterpret_cast<float*>(s);
    A.a = reinterpret_cast<float*>(a);
    const int n_tiles = (L + kTile - 1) / kTile;
    const dim3 grid((G / heads) * A.groups_per_chunk * n_tiles + G);
    const cudaStream_t st = (cudaStream_t)stream;
    if (bc_bf16) {
      ssd_scan_kernel<true><<<grid, kThreads, kSmemBytes, st>>>(A);
    } else {
      ssd_scan_kernel<false><<<grid, kThreads, kSmemBytes, st>>>(A);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
