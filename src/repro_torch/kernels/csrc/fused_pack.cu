// fused_pack.cu -- one-pass Alg. 3 wire encode of a whole parameter dict.
//
// Replaces: src/repro/kernels/fused_pack.py::_fused_pack_call (the
// pallas_call at :158, body _fused_kernel :95, field scatter
// _scatter_field :74) of the JAX package.
//
// What it computes, per leaf (bit-exact with the JAX kernel and with the
// plain version fused_pack_plain in fused_pack.py):
//   1. T = the exact k-th largest |x| bit pattern (x & 0x7fffffff), by a
//      31-step greedy search, MSB to LSB, keeping a bit iff >= k patterns
//      still clear the candidate;
//   2. keep |x| > T, plus the first (k - #above) elements tied at T in
//      index order (the wire format's smallest-index tie rule);
//   3. offset-binary levels round((x / scale) * L) + L with the f32
//      max-abs scale of the survivors (or raw f32 patterns at p_q >= 32);
//   4. survivor r's delta-coded index sel[r] - sel[r-1] (sel[-1] = 0);
//   5. every field ORed into big-endian uint32 stream words at its bit
//      offset: leaf base + [scale 32b][k values][k deltas].
//
// What bounds it on an H100: the data is small (206,410 f32 for the
// paper's CNN: 0.83 MB in, 0.67 MB of stream out at (0.25, 8)), so the
// least time to move it is well under a microsecond at 3.35 TB/s; the
// kernel is bound by latency: the launch, and the serial chain of 33
// block-wide reductions and the ordered tile scans inside the CTA of the
// largest leaf (fc1, 200,704 elements), which one SM walks alone.
//
// What the design does about it: one launch for the whole dict, one CTA
// per leaf, so the small leaves finish under the fc1 CTA's shadow and the
// host pays one launch.  Each leaf's starting bit in the stream depends on
// shapes only, so the host passes it in and every CTA ORs its fields
// straight into one zeroed word buffer with atomicOr -- exact, because no
// two fields share a bit -- and no concatenation pass follows.  The fc1
// CTA stays the long pole; a multi-CTA radix select is later work.
//
// Rounding: the f32 expressions use the _rn intrinsics, rintf rounds half
// to even, and the build passes -fmad=false without --use_fast_math, so
// every rounding matches XLA's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 1024;

// one row per leaf, all int64: x pointer, n, k, stream bit offset, index bits
struct LeafMeta {
  long long x;
  long long n;
  long long k;
  long long bit_off;
  long long ibits;
};

template <typename T>
struct MaxOp {
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a > b ? a : b;
  }
};

typedef cub::BlockScan<int, kThreads> Scan;
typedef cub::BlockReduce<int, kThreads> ReduceI;
typedef cub::BlockReduce<unsigned, kThreads> ReduceU;

struct Shared {
  union {
    Scan::TempStorage scan;
    ReduceI::TempStorage ri;
    ReduceU::TempStorage ru;
  } tmp;
  int bcast_i;
  unsigned bcast_u;
};

__device__ __forceinline__ unsigned pattern(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, Shared& sh) {
  int tot = ReduceI(sh.tmp.ri).Sum(v);
  if (threadIdx.x == 0) sh.bcast_i = tot;
  __syncthreads();
  tot = sh.bcast_i;
  __syncthreads();
  return tot;
}

// OR the low `width` bits of val into the stream at bit offset `off`
// (MSB first, big-endian words): one 64-bit window over words w and w+1.
__device__ __forceinline__ void or_field(unsigned* words, long long off,
                                         unsigned val, int width) {
  long long w = off >> 5;
  int s = (int)(off & 31);
  unsigned long long v = (unsigned long long)val << (64 - s - width);
  unsigned hi = (unsigned)(v >> 32);
  unsigned lo = (unsigned)(v & 0xffffffffull);
  if (hi) atomicOr(words + w, hi);
  if (lo) atomicOr(words + w + 1, lo);
}

__global__ void __launch_bounds__(kThreads)
fused_pack_kernel(const LeafMeta* __restrict__ meta,
                  unsigned* __restrict__ words, int p_q) {
  __shared__ Shared sh;
  const LeafMeta m = meta[blockIdx.x];
  const float* __restrict__ x = reinterpret_cast<const float*>(m.x);
  const int n = (int)m.n;
  const int k = (int)m.k;
  const int tid = threadIdx.x;
  const bool quantized = p_q < 32;
  const int vbits = quantized ? p_q : 32;
  const int L = quantized ? (1 << (p_q - 1)) - 1 : 0;

  // max |x| over the leaf: the largest magnitude always survives, so it is
  // also the max over the survivors (the JAX kernel's scale)
  unsigned pmax = 0;
  for (int j = tid; j < n; j += kThreads) pmax = max(pmax, pattern(x[j]));
  pmax = ReduceU(sh.tmp.ru).Reduce(pmax, MaxOp<unsigned>());
  if (tid == 0) sh.bcast_u = pmax;
  __syncthreads();
  pmax = sh.bcast_u;
  __syncthreads();
  const float scale =
      quantized ? fmaxf(__uint_as_float(pmax), 1e-12f) : 1.0f;
  if (tid == 0) or_field(words, m.bit_off, __float_as_uint(scale), 32);

  // exact k-th largest pattern T, and #patterns strictly above it
  unsigned thr = 0;
  int need = 0;                       // ties at T that survive
  if (k < n) {
    for (int bit = 30; bit >= 0; --bit) {
      const unsigned cand = thr | (1u << bit);
      int c = 0;
      for (int j = tid; j < n; j += kThreads) c += pattern(x[j]) >= cand;
      if (block_sum(c, sh) >= k) thr = cand;
    }
    int c = 0;
    for (int j = tid; j < n; j += kThreads) c += pattern(x[j]) > thr;
    need = k - block_sum(c, sh);
  }

  const long long val_base = m.bit_off + 32;
  const long long idx_base = val_base + (long long)k * vbits;
  const int ibits = (int)m.ibits;
  int tie_carry = 0;                  // ties seen in earlier tiles
  int rank_carry = 0;                 // survivors in earlier tiles
  int prev_carry = 0;                 // index of the last survivor so far
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + tid;
    const bool valid = j < n;
    const float v = valid ? x[j] : 0.0f;
    const unsigned b = pattern(v);
    int keep;
    if (k < n) {
      const int tie = (valid && b == thr) ? 1 : 0;
      int tie_rank, tie_tot;
      Scan(sh.tmp.scan).ExclusiveSum(tie, tie_rank, tie_tot);
      __syncthreads();
      keep = valid && (b > thr || (tie && tie_carry + tie_rank < need));
      tie_carry += tie_tot;
    } else {
      keep = valid ? 1 : 0;
    }
    int rank, rank_tot;
    Scan(sh.tmp.scan).ExclusiveSum(keep, rank, rank_tot);
    __syncthreads();
    int prev = -1, last = -1;
    if (k < n) {
      Scan(sh.tmp.scan).ExclusiveScan(keep ? j : -1, prev, -1, MaxOp<int>(),
                                       last);
      __syncthreads();
    }
    if (keep) {
      const long long r = rank_carry + rank;
      unsigned field;
      if (quantized) {
        float q = rintf(__fmul_rn(__fdiv_rn(v, scale), (float)L));
        q = fminf(fmaxf(q, (float)-L), (float)L);
        field = (unsigned)((int)q + L);
      } else {
        field = __float_as_uint(v);
      }
      or_field(words, val_base + r * vbits, field, vbits);
      if (k < n) {
        const int p = prev >= 0 ? prev : prev_carry;
        or_field(words, idx_base + r * ibits, (unsigned)(j - p), ibits);
      }
    }
    rank_carry += rank_tot;
    if (last >= 0) prev_carry = last;
  }
}

}  // namespace

extern "C" {

// Encode n_leaves leaves (meta: device array of LeafMeta rows) into the
// zeroed stream `words`, on `stream`.  Returns cudaGetLastError().
int fused_pack_launch(const void* meta, int n_leaves, void* words, int p_q,
                      void* stream) {
  if (n_leaves > 0) {
    fused_pack_kernel<<<n_leaves, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const LeafMeta*>(meta),
        reinterpret_cast<unsigned*>(words), p_q);
  }
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
