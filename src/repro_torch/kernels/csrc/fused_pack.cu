// fused_pack.cu -- one-pass Alg. 3 wire encode of a whole parameter dict.
//
// Replaces: src/repro/kernels/fused_pack.py::_fused_pack_call (the
// pallas_call at :158, body _fused_kernel :95, field scatter
// _scatter_field :74) of the JAX package.
//
// What it computes, per leaf (bit-exact with the JAX kernel and with the
// plain version fused_pack_plain in fused_pack.py):
//   1. T = the exact k-th largest |x| bit pattern (x & 0x7fffffff);
//   2. keep |x| > T, plus the first (k - #above) elements tied at T in
//      index order (the wire format's smallest-index tie rule);
//   3. offset-binary levels round((x / scale) * L) + L with the f32
//      max-abs scale of the survivors (or raw f32 patterns at p_q >= 32);
//   4. survivor r's delta-coded index sel[r] - sel[r-1] (sel[-1] = 0);
//   5. every field written into big-endian uint32 stream words at its bit
//      offset: leaf base + [scale 32b][k values][k deltas].
//
// What bounds it on an H100: the data is small (206,410 f32 for the
// paper's CNN: 0.83 MB in, 0.17 MB of stream out at (0.25, 8)), so moving
// it takes well under a microsecond at 3.35 TB/s; what costs is the chain
// of dependent steps -- a max, a select, ranks, then the writes -- over
// the largest leaf (fc1, 200,704 elements).  Walked by one SM, that chain
// is the kernel.
//
// What the design does about it:
// * One launch for the whole dict.  A leaf of more than BIG_LEAF (16,384,
//   fused_pack.py) elements is spread over a thread-block cluster of
//   kCluster CTAs, each holding a contiguous slice in shared memory (fc1:
//   100 KB per CTA), so the leaf is read from device memory once and 8
//   SMs share every pass.  Smaller leaves take one CTA each, grouped
//   kCluster to a cluster with no cluster barrier between them.  Which CTA
//   takes which slice depends on shapes only: the wrapper computes it and
//   passes it in the meta rows.
// * Radix select instead of a 31-step binary search: four passes of 8
//   bits over the patterns.  Each CTA builds the 256-bin histogram of its
//   slice restricted to the prefix found so far (one histogram per warp,
//   so that shared atomics contend only inside a warp, summed per CTA);
//   the cluster sums the CTAs' histograms through distributed shared
//   memory and every CTA picks the same digit.  The first pass runs as the
//   slice is loaded and carries the max-abs reduction.  T and the count
//   above it are the numbers the binary search finds.
// * One scan per quantity: each thread owns a contiguous run of its slice
//   and counts ties, survivors and its last survivor serially; a block
//   scan and a cluster-wide exclusive prefix over the per-CTA totals give
//   it its tie rank, survivor rank and previous survivor (the number of
//   ties in earlier CTAs comes from their last histogram).
// * A run's value fields, and its delta fields, are two contiguous bit
//   ranges of the stream.  The thread writes each with a bit writer in
//   registers: whole words are stored, and only the first and last word
//   of a range, which it may share with the neighbouring runs, are ORed
//   into device memory.  Neighbouring runs are neighbours in the stream,
//   so a warp's stores land close together.
// * Histogram buffers alternate between passes, so one cluster barrier per
//   pass suffices, and no CTA of a cluster exits while a peer may still
//   read its shared memory.
//
// What still bounds it (cycles per phase: scripts/kernel_phases.py): 8 SMs
// walk fc1, 25 elements per thread in each of six passes; the emission
// pass (per survivor an IEEE division, for bit-exactness, and two
// bit-writer appends) is a third of an fc1 CTA's cycles, and the five
// cluster barriers a seventh.
//
// Rounding: the f32 expressions use the _rn intrinsics, rintf rounds half
// to even, and the build passes -fmad=false without --use_fast_math, so
// every rounding matches XLA's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kCluster = 8;           // CTAs per cluster (the portable size)
constexpr int kMaxSlice = 47104;      // f32 of a slice held in shared memory
constexpr int kBins = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDynSmem = (size_t)(kMaxSlice + kWarps * kBins) * 4;

// One row per CTA, all int64: x pointer, n, k, stream bit offset, index
// bits, first element of the slice, slice length, CTAs sharing the leaf
// (kCluster, or 1 for a leaf of its own; n < 0 marks an idle CTA).
struct Row {
  long long x;
  long long n;
  long long k;
  long long bit_off;
  long long ibits;
  long long start;
  long long len;
  long long slices;
};

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};
struct MaxU {
  __device__ __forceinline__ unsigned operator()(unsigned a,
                                                 unsigned b) const {
    return a > b ? a : b;
  }
};

typedef cub::BlockScan<int, kThreads> Scan;
typedef cub::BlockReduce<unsigned, kThreads> ReduceU;

struct Shared {
  union {
    Scan::TempStorage scan;
    ReduceU::TempStorage ru;
  } tmp;
  unsigned hist[2][kBins + 1];   // by pass parity; [0][kBins]: max pattern
  unsigned tot[kBins];           // the cluster's histogram of this pass
  int totals[2];                 // this CTA's survivors, last survivor
  unsigned gmax;
  int digit, above, ties_before, rank_base, prev;
};

__device__ __forceinline__ unsigned pattern(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// every CTA of the leaf has reached this point (one CTA: the block has)
__device__ __forceinline__ void leaf_sync(int slices) {
  if (slices > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `p` in the shared memory of slice `r` of the leaf
template <typename T>
__device__ __forceinline__ T* peer(T* p, int r, int slices) {
  return slices > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
}

// Appends fields to the stream from bit `pos` on, as one thread writes
// its run's survivors: whole words are stored, the first word (which may
// hold the previous run's last bits) and the last (the next run's first)
// are ORed.
struct BitWriter {
  unsigned* words;
  long long w;                  // the word being filled
  unsigned long long buf;       // pending bits, from bit 63 down
  int nb;                       // pending bits, the first word's leading
                                // bits (someone else's) counting as zeros
  bool first;
  __device__ BitWriter(unsigned* words_, long long pos)
      : words(words_), w(pos >> 5), buf(0), nb((int)(pos & 31)),
        first(true) {}
  __device__ __forceinline__ void put(unsigned f, int width) {
    buf |= (unsigned long long)f << (64 - nb - width);
    nb += width;
    if (nb >= 32) {
      const unsigned word = (unsigned)(buf >> 32);
      if (first) {
        if (word) atomicOr(words + w, word);
        first = false;
      } else {
        words[w] = word;
      }
      ++w;
      buf <<= 32;
      nb -= 32;
    }
  }
  __device__ __forceinline__ void finish() {
    const unsigned word = (unsigned)(buf >> 32);
    if (nb > 0 && word) atomicOr(words + w, word);
  }
};

__global__ void __launch_bounds__(kThreads)
fused_pack_kernel(const Row* __restrict__ meta, unsigned* __restrict__ words,
                  int p_q) {
  extern __shared__ __align__(16) unsigned dyn[];
  __shared__ Shared sh;
  const Row m = meta[blockIdx.x];
  if (m.n < 0) return;                // idle CTA of a cluster of small leaves
  const int slices = (int)m.slices;
  const int rank = slices > 1 ? (int)(blockIdx.x % kCluster) : 0;
  const int n = (int)m.n, k = (int)m.k;
  const int s0 = (int)m.start, len = (int)m.len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool quantized = p_q < 32;
  const int vbits = quantized ? p_q : 32;
  const int L = quantized ? (1 << (p_q - 1)) - 1 : 0;
  const bool select = k < n;
  const float* xg = reinterpret_cast<const float*>(m.x) + s0;
  // a slice too long for shared memory is read from device memory
  const bool in_smem = len <= kMaxSlice;
  float* data = reinterpret_cast<float*>(dyn);
  const float* x = in_smem ? data : xg;
  // after the slice: one histogram per warp
  unsigned* wh = dyn + kMaxSlice;
  unsigned* my_h = wh + warp * kBins;

  // the warps' histograms summed into h, and zeroed again
  auto gather = [&](unsigned* h) {
    __syncthreads();
    for (int b = tid; b < kBins; b += kThreads) {
      unsigned t = 0;
      for (int w = 0; w < kWarps; ++w) {
        t += wh[w * kBins + b];
        wh[w * kBins + b] = 0u;
      }
      h[b] = t;
    }
  };

  // the slice into shared memory, its max pattern, and the first radix
  // pass's histogram (8 loads in flight per thread before the first store)
  for (int i = tid; i < kWarps * kBins; i += kThreads) wh[i] = 0u;
  __syncthreads();
  unsigned pmax = 0;
  for (int base = 0; base < len; base += 8 * kThreads) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = base + u * kThreads + tid;
      v[u] = j < len ? __ldg(xg + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = base + u * kThreads + tid;
      if (j < len && in_smem) data[j] = v[u];
      pmax = max(pmax, pattern(v[u]));
      if (select && j < len) atomicAdd(&my_h[pattern(v[u]) >> 24], 1u);
    }
  }
  pmax = ReduceU(sh.tmp.ru).Reduce(pmax, MaxU());
  if (select) gather(sh.hist[0]);
  if (tid == 0) sh.hist[0][kBins] = pmax;
  __syncthreads();

  // radix select, 8 bits a pass from the top; pass 0 also carries the max
  unsigned prefix = 0, pmask = 0;
  int kk = k;                         // rank of T inside the prefix's class
  const int passes = select ? 4 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    unsigned* h = sh.hist[pass & 1];
    const int shift = 24 - 8 * pass;
    if (pass > 0) {
      // (h's last readers passed the previous pass's barrier)
      for (int j = tid; j < len; j += kThreads) {
        const unsigned p = pattern(x[j]);
        if ((p & pmask) == prefix) atomicAdd(&my_h[(p >> shift) & 0xffu], 1u);
      }
      gather(h);
    }
    leaf_sync(slices);                // every slice's histogram is complete
    for (int b = tid; b < kBins; b += kThreads) {
      unsigned t = 0;
      if (slices > 1) {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int r = 0; r < kCluster; ++r) t += cl.map_shared_rank(h, r)[b];
      } else {
        t = h[b];
      }
      sh.tot[b] = t;
    }
    if (pass == 0 && tid == 0) {
      unsigned g = 0;
      for (int r = 0; r < slices; ++r) g = max(g, peer(h, r, slices)[kBins]);
      sh.gmax = g;
    }
    __syncthreads();
    if (!select) break;
    if (tid < 32) {
      // lane i owns bins [8i, 8i + 8); suffix sums find the bin of rank kk
      unsigned own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) own += sh.tot[8 * lane + b];
      unsigned suf = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += v;
      }
      unsigned above = suf - own;     // in bins >= 8 * lane + 8
      if (above < (unsigned)kk && (unsigned)kk <= suf) {
        for (int b = 7; b >= 0; --b) {
          const unsigned t = sh.tot[8 * lane + b];
          if (above + t >= (unsigned)kk) {
            sh.digit = 8 * lane + b;
            sh.above = (int)above;
            break;
          }
          above += t;
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned)sh.digit << shift;
    pmask |= 0xffu << shift;
    kk -= sh.above;
  }
  const unsigned thr = prefix;        // T, when select
  const int need = kk;                // ties at T that survive
  const float scale =
      quantized ? fmaxf(__uint_as_float(sh.gmax), 1e-12f) : 1.0f;
  if (rank == 0 && tid == 0) {
    BitWriter sw(words, m.bit_off);
    sw.put(__float_as_uint(scale), 32);
    sw.finish();
  }
  // ties at T in earlier slices: their last histogram's bin of T
  if (tid == 0) {
    int t = 0;
    if (select) {
      for (int r = 0; r < rank; ++r) {
        t += (int)peer(sh.hist[(passes - 1) & 1], r, slices)[sh.digit];
      }
    }
    sh.ties_before = t;
  }

  // this thread's run of the slice
  const int run = (len + kThreads - 1) / kThreads;
  const int a = min(len, tid * run), b = min(len, a + run);
  int tie0 = 0;                       // rank of this run's first tie at T
  if (select) {
    int ties = 0;
    for (int j = a; j < b; ++j) ties += pattern(x[j]) == thr;
    Scan(sh.tmp.scan).ExclusiveSum(ties, tie0);
    __syncthreads();
    tie0 += sh.ties_before;
  }
  auto keep = [&](unsigned p, int& tie) {
    if (!select) return true;
    if (p > thr) return true;
    if (p != thr) return false;
    return tie++ < need;
  };
  int count = 0, last = -1;
  {
    int tie = tie0;
    for (int j = a; j < b; ++j) {
      if (keep(pattern(x[j]), tie)) {
        ++count;
        last = s0 + j;
      }
    }
  }
  int rank0, prev0, total, last_total;
  Scan(sh.tmp.scan).ExclusiveSum(count, rank0, total);
  __syncthreads();
  Scan(sh.tmp.scan).ExclusiveScan(last, prev0, -1, MaxOp(), last_total);
  if (tid == 0) {
    sh.totals[0] = total;
    sh.totals[1] = last_total;
  }
  leaf_sync(slices);                  // every slice's totals are published
  if (tid == 0) {
    int base = 0, prev = -1;
    for (int r = 0; r < rank; ++r) {
      const int* t = peer(sh.totals, r, slices);
      base += t[0];
      prev = max(prev, t[1]);
    }
    sh.rank_base = base;
    sh.prev = prev;
  }
  __syncthreads();
  rank0 += sh.rank_base;
  if (prev0 < 0) prev0 = sh.prev >= 0 ? sh.prev : 0;

  // this run's values and delta-coded indices: two contiguous bit ranges
  if (count > 0) {
    const long long val_base = m.bit_off + 32;
    const long long idx_base = val_base + (long long)k * vbits;
    const int ibits = (int)m.ibits;
    BitWriter vw(words, val_base + (long long)rank0 * vbits);
    BitWriter dw(words, idx_base + (long long)rank0 * ibits);
    int tie = tie0, prev = prev0;
    for (int j = a; j < b; ++j) {
      const float v = x[j];
      if (!keep(pattern(v), tie)) continue;
      if (quantized) {
        float q = rintf(__fmul_rn(__fdiv_rn(v, scale), (float)L));
        q = fminf(fmaxf(q, (float)-L), (float)L);
        vw.put((unsigned)((int)q + L), vbits);
      } else {
        vw.put(__float_as_uint(v), 32);
      }
      if (select) {
        dw.put((unsigned)(s0 + j - prev), ibits);
        prev = s0 + j;
      }
    }
    vw.finish();
    if (select) dw.finish();
  }
  leaf_sync(slices);                  // no peer reads this CTA's memory now
}

// the dynamic shared memory of a launch, set once per process
cudaError_t configure_once() {
  static cudaError_t status = cudaFuncSetAttribute(
      fused_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDynSmem);
  return status;
}

}  // namespace

extern "C" {

// Encode the leaves described by n_rows meta rows (a device array of Row,
// one per CTA, n_rows a multiple of kCluster) into the zeroed stream
// `words`, on `stream`.  Returns cudaGetLastError().
int fused_pack_launch(const void* meta, int n_rows, void* words, int p_q,
                      void* stream) {
  if (n_rows < 0 || n_rows % kCluster) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kDynSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_pack_kernel,
                           reinterpret_cast<const Row*>(meta),
                           reinterpret_cast<unsigned*>(words), p_q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
