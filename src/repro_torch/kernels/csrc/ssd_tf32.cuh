// ssd_tf32.cuh -- split-TF32 warpgroup MMAs and their operand loaders, shared
// by kernel C (ssd_scan.cu) and its backward (ssd_scan_bwd.cu).
//
// A product runs on the tensor cores as wgmma .tf32 with f32 accumulators;
// each f32 operand is split into hi = tf32(a) and lo = tf32(a - hi), and a
// product is lo*hi + hi*lo + hi*hi (ssd_scan.cu's header says why).  The
// operands live in shared memory in the no-swizzle K-major layout below,
// or, for A, in registers.  Everything here is for CTAs of kThreads threads
// (two warpgroups) and operand tiles of kTile rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows of an operand tile (the MMA's M)
constexpr int kThreads = 256;        // two warpgroups
constexpr int kMaxN = 128;           // columns of a b or c row tile


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

}  // namespace
