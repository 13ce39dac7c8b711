// topk_quant.cu -- block-local threshold Top-K plus symmetric quantization
// of a whole list of leaves in one launch.
//
// Replaces: src/repro/kernels/topk_quant.py::topk_quant (the pallas_call at
// :75, body _kernel :33) of the JAX package.
//
// What it computes, per row of `block` values of a leaf (the leaf cut into
// ceil(n / block) rows, the last one zero-padded; the padding counts in the
// kept fraction), bit-exact with the JAX kernel and with topk_quant_plain
// in topk_quant.py:
//   1. hi = max|x| + 1e-12, lo = 0, then `iters` bisection steps
//      mid = 0.5 * (lo + hi); keep mid as lo iff count(|x| >= mid) / block
//      > p_s;
//   2. thr = 0.5 * (lo + hi); kept = |x| >= thr ? x : 0;
//   3. scale = max(max|kept|, 1e-12); levels = clip(round(kept / scale * L),
//      -L, L) as int8, L = 2^(bits-1) - 1, round half to even.
//
// What bounds it on an H100: the paper's CNN is 206,410 f32 (0.83 MB in,
// 0.33 MB of levels out at block 16,384), which moves in a third of a
// microsecond at 3.35 TB/s.  What costs is latency: the launch, and the
// chain of dependent steps over each row (a max, the bisection's counts,
// the quantization), each ending in a block-wide or cluster-wide barrier.
//
// What the design does about it:
// * One launch for a list of up to kMaxLeaves leaves, described by a
//   per-leaf table passed by value (`__grid_constant__`): data pointer,
//   element count, first output row.  A CTA finds its leaf by a binary
//   search over the first rows, and reads its row straight from the
//   unpadded leaf: the pad is never read or compared (it holds no value
//   >= mid, since mid > 0), only counted in `block`, and its levels are
//   written as zeros.
// * A k-ary bisection: each pass over a row takes kRadixBits = 8 bisection
//   steps at once.  From (lo, hi) all threads build the 255 midpoints of
//   the next 8 steps, each by descending the tree of the sequential
//   loop's midpoints with its f32 recursion (in order they are sorted,
//   because 0.5 * (lo + hi) rounded to nearest stays within [lo, hi]).
//   Each |x| is binned by how many midpoints are <= |x|, into one
//   histogram per CTA and pass.  The count at midpoint j is the sum of
//   the bins from j up; it falls as j grows, so the 8 sequential decisions
//   (count / block > p_s in IEEE f32, i.e. count >= need, the least such
//   count, which the wrapper passes) end at (mid[K], mid[K + 1]), K the
//   number of midpoints kept: one warp counts K, nobody walks the tree.
//   So 16 steps take 2 passes (12 take 2, 5 take 1), each with one
//   reduction, where the sequential loop takes 16.  8 and not 4 bits a
//   pass: the bin of |x| is estimated from its position in [lo, hi) and
//   settled by its four neighbouring midpoints without a branch (a search
//   only where the interval is a few ulps wide), so a pass costs about the
//   same whatever its width, and fewer passes mean fewer barriers.  Each
//   thread bins 8 values at once; values below every midpoint (bin 0)
//   count nowhere and are not recorded, values at or above hi are counted
//   in registers, and a warp with no value in [lo, hi) skips the binning.
// * No pass for the kept max: the largest kept magnitude is max|x| when
//   max|x| >= thr, else 0, so scale = max(amax >= thr ? amax : 0, 1e-12).
//   A row costs one max, ceil(iters / 8) histogram reductions and the
//   quantize-and-store pass (4 neighbouring values a thread, one 4-byte
//   store).
// * A row takes one CTA per 4,096 values (CTA_ROW in topk_quant.py), up to
//   a thread-block cluster of kCluster: the wrapper passes `slices`.  Each
//   CTA holds a contiguous slice in shared memory, loaded with 16-byte
//   loads where aligned; maxima and histograms are summed through
//   distributed shared memory, one cluster barrier per pass, with
//   histogram buffers alternating between passes.  A slice longer than
//   kMaxSlice is read from device memory on every pass.  All rows of a
//   launch share `block`, so they share the cluster size.  Measured on
//   the card at block 16,384 (PERF.md, kernel B): a 4-CTA cluster of 512
//   threads beats one CTA a row, 2- and 8-CTA clusters, and 1,024 threads.
// * The dynamic shared memory attribute is set once per process.
//
// Rounding: counts are exact integers; the mean is count / block in IEEE
// f32 division (exact for counts and blocks below 2^24, and the same
// expression as XLA's mean).  The other f32 expressions use the _rn
// intrinsics, rintf rounds half to even, and the build passes -fmad=false
// without --use_fast_math.
//
// The channel form (topk_channel_run) is the cohort trainer's threshold
// channel: src/repro/core/compression.py::sparsify_quantize_threshold
// (:102) under jax.vmap over a leaf's leading device axis, as jax.jit
// compiles it.  Each row is one device's leaf, of its own length with no
// pad.  Differences from the block form:
// * XLA multiplies by the f32 reciprocal of a constant divisor, so the kept
//   fraction is count * f32(1/len) (the wrapper's need follows that rule,
//   kernels/topk_quant.py::channel_need) and the value written is
//   (level * scale) * f32(1/L), in the leaf's dtype and layout, 0 where
//   dropped; levels stay f32 in registers, so bits 2..16 are taken, and
//   bits = 32 writes x where kept;
// * keep_all (p_s >= 1) skips the search and keeps every value;
// * on request it also writes the wire of the federated round's mesh
//   branch (src/repro/core/fed_step.py::compress_delta, :81): each value's
//   int8 level (0 where dropped) into the leaf's level buffer and each
//   row's f32 scale; bits 2..8;
// * one C call runs the wrapper's whole plan (kernels/topk_quant.py::
//   channel_plan), a table of entries, each of up to kMaxLeaves leaves,
//   over two routes:
//   - the cluster route, rows of fewer than WIDE_MIN = 376,833 values (an
//     8-CTA cluster's slices fit shared memory up to 376,832): this kernel
//     (kChannel = true), one launch per cluster size, so the CNN's 8
//     leaves take 2 launches (fc1's rows on 8-CTA clusters, the other
//     seven one CTA a row);
//   - the wide route, longer rows: one CTA per tile over the whole card,
//     the rows' state in a device workspace, 12 bisection steps a pass
//     (below, "The channel form's wide route").  One cluster a row had left
//     a long row on 8 of the card's 132 SMs, its slices read from device
//     memory again on every pass: one row of 80 M values took 24 ms, twice
//     its plain version (PERF.md, kernel B).
//   The boundary is measured (chip_smoke.py phase 35's sweep): at 2^18
//   values a row the cluster route is as fast or faster (4 rows: 0.047
//   against 0.062 ms), at 2^19 the wide route is 2-3x faster.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;         // bisection steps per pass
constexpr int kBins = 1 << kRadixBits;
constexpr int kCluster = 8;           // CTAs of a cluster (the portable size)
constexpr int kMaxSlice = 47104;      // f32 of a slice held in shared memory
constexpr int kMaxLeaves = 64;
constexpr int kBatch = 8;             // values a thread has in flight
constexpr size_t kMaxDynSmem = (size_t)kMaxSlice * 4;

// The length of each CTA's slice of a row: the row, or over a cluster a
// multiple of 4 values (so that slices of an aligned row stay aligned for
// 16-byte loads and 4-byte stores); the last slices may be shorter or
// empty.
__host__ __device__ __forceinline__ int slice_len(int block, int slices) {
  return slices == 1 ? block : ((block + slices - 1) / slices + 3) & ~3;
}

// The leaves of one launch: data pointer, element count, first output row
// (rows of a leaf are consecutive; first[0] is the launch's first row);
// the channel form adds each leaf's output, row length and need, and
// where the wire is asked for, its level buffer.
struct Leaves {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  int8_t* lvl[kMaxLeaves];    // the channel form's levels, or null
  long long n[kMaxLeaves];
  long long first[kMaxLeaves];
  int len[kMaxLeaves];
  int need[kMaxLeaves];
  int count;
};

struct Shared {
  unsigned hist[2][kBins];    // this CTA's histogram, by pass parity
  unsigned tot[kBins];        // the row's histogram, over a cluster
  float mid[2][kBins + 1];    // by pass parity: mid[0] = lo, the
                              // midpoints, mid[nb] = hi
  unsigned wmax[kWarps];
  unsigned cmax;              // this CTA's max |x| pattern (peers read it)
  int keep;                   // the pass's count of midpoints kept
};

// bf16 is the high half of an f32: widening is a shift, exact
__device__ __forceinline__ float load(const void* x, long long i,
                                      int is_bf16) {
  if (is_bf16) {
    const unsigned short h = reinterpret_cast<const unsigned short*>(x)[i];
    return __uint_as_float(((unsigned)h) << 16);
  }
  return __ldg(reinterpret_cast<const float*>(x) + i);
}

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// every CTA of the row has reached this point (one CTA: the block has)
__device__ __forceinline__ void row_sync(int slices) {
  if (slices > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// `p` in the shared memory of slice `r` of the row
template <typename T>
__device__ __forceinline__ T* peer(T* p, int r, int slices) {
  return slices > 1 ? cg::this_cluster().map_shared_rank(p, r) : p;
}

// The midpoints of the next `depth` bisection steps from (lo, hi), in
// order: node j of the tree is reached by descending from (lo, hi), so
// each is the midpoint the sequential loop computes from the same
// endpoints.  All threads share the 2^depth - 1 nodes.
__device__ __forceinline__ void build_midpoints(float* mid, float lo,
                                                float hi, int depth) {
  const int nb = 1 << depth;
  for (int j = threadIdx.x; j <= nb; j += kThreads) {
    float m = j == 0 ? lo : hi;
    if (j > 0 && j < nb) {
      float l = lo, r = hi;
      int c = nb >> 1, half = nb >> 2;
      for (;;) {
        m = midpoint(l, r);
        if (j == c) break;
        if (j < c) {
          r = m;
          c -= half;
        } else {
          l = m;
          c += half;
        }
        half >>= 1;
      }
    }
    mid[j] = m;
  }
}

// The bin of a in [lo, hi): the number of midpoints <= a, i.e. the largest
// t with mid[t] <= a.  `e` is an estimate from a's position in [lo, hi);
// the midpoints are nearly evenly spaced, so the bin is within one of it,
// which four neighbouring midpoints settle without a branch.  Returns -1
// where it is not (an interval only a few ulps wide): bin_search then.
__device__ __forceinline__ int bin_near(float a, int e, const float* mid,
                                        int nb) {
  const float m0 = mid[max(e - 1, 0)], m1 = mid[e];
  const float m2 = mid[e + 1], m3 = mid[min(e + 2, nb)];
  const int up = m2 <= a ? (m3 <= a ? -1 : e + 1) : e;
  return m1 <= a ? up : (m0 <= a ? e - 1 : -1);
}

__device__ __noinline__ int bin_search(float a, int e, const float* mid,
                                       int nb) {
  int t = e;
  while (t < nb - 1 && mid[t + 1] <= a) ++t;
  while (t > 0 && mid[t] > a) --t;
  return t;
}

__device__ __forceinline__ int quantize(float v, float thr, float scale,
                                        float L) {
  float q = 0.0f;
  if (fabsf(v) >= thr) {
    q = rintf(__fmul_rn(__fdiv_rn(v, scale), L));
    q = fminf(fmaxf(q, -L), L);
  }
  return (int)q;
}

// The channel form's value: 0 where dropped, x where kept without
// quantization, else (level * scale) * f32(1/L) with the level kept in f32
// (a level of -0 gives -0, as XLA's does); the level goes to *q (0 where
// dropped).
__device__ __forceinline__ float channel_value(float v, float thr,
                                               float scale, float L,
                                               float inv_l, bool quant,
                                               float* q) {
  *q = 0.0f;
  if (!(fabsf(v) >= thr)) return 0.0f;
  if (!quant) return v;
  *q = fminf(fmaxf(rintf(__fmul_rn(__fdiv_rn(v, scale), L)), -L), L);
  return __fmul_rn(__fmul_rn(*q, scale), inv_l);
}

// f32 -> bf16 bits, rounding to nearest even
__device__ __forceinline__ unsigned short to_bf16(float f) {
  const unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (unsigned short)(u >> 16 | 64);
  return (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// kChannel = false: the block form (levels and scales); true: the channel
// form (row length and need per leaf, values written to the leaf's output),
// and with kWire its levels and row scales too (a separate instance, so
// that the channel form without the wire compiles as it did).  Two CTAs an
// SM: 64 registers a thread (measured on the card: the wire instance took
// 103 without the bound and 1.7x the time of the channel without it).
// A slice of at most smem_cap values is held in shared memory.
template <bool kChannel, bool kWire = false>
__global__ void __launch_bounds__(kThreads, 2)
topk_quant_kernel(const __grid_constant__ Leaves leaves, int is_bf16,
                  int block_arg, int slices, int need_arg, int bits,
                  int iters, int smem_cap, int keep_all,
                  int8_t* __restrict__ levels, float* __restrict__ scales) {
  extern __shared__ __align__(16) unsigned dyn[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)(blockIdx.x % slices);
  const long long row = leaves.first[0] + blockIdx.x / slices;

  // the leaf of this row: the last whose first row is <= row
  int lf = 0;
  for (int step = kMaxLeaves / 2; step > 0; step >>= 1) {
    if (lf + step < leaves.count && leaves.first[lf + step] <= row) {
      lf += step;
    }
  }
  const int block = kChannel ? leaves.len[lf] : block_arg;
  const int need = kChannel ? leaves.need[lf] : need_arg;
  if (keep_all) iters = 0;
  const long long row_start = (row - leaves.first[lf]) * block;
  const long long avail = leaves.n[lf] - row_start;   // values in the leaf
  const int valid = (int)(avail < block ? (avail > 0 ? avail : 0) : block);
  // this CTA's slice [s0, s1) of the row; values below `len` are data
  const int part = slice_len(block, slices);
  const int s0 = min(block, rank * part), s1 = min(block, s0 + part);
  const int len = max(0, min(s1, valid) - s0);
  const bool in_smem = part <= smem_cap;
  const long long g0 = row_start + s0;                // in the leaf
  const void* xg = leaves.x[lf];
  float* data = reinterpret_cast<float*>(dyn);
  auto at = [&](int j) -> float {
    return in_smem ? data[j] : load(xg, g0 + j, is_bf16);
  };

  // the slice into shared memory, and its max |x|: 16-byte loads where
  // the slice is aligned f32, all of a thread's loads in flight at once
  for (int i = tid; i < 2 * kBins; i += kThreads) sh.hist[0][i] = 0u;
  unsigned pmax = 0u;
  const float4* x4 = reinterpret_cast<const float4*>(
      reinterpret_cast<const float*>(xg) + g0);
  const int n4 = !is_bf16 && (reinterpret_cast<uintptr_t>(x4) & 15) == 0
                     ? len >> 2 : 0;
  for (int base = 0; base < n4; base += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      v[u] = i < n4 ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kThreads + tid;
      if (i < n4 && in_smem) reinterpret_cast<float4*>(data)[i] = v[u];
      pmax = max(pmax, max(max(abs_bits(v[u].x), abs_bits(v[u].y)),
                           max(abs_bits(v[u].z), abs_bits(v[u].w))));
    }
  }
  for (int base = 4 * n4; base < len; base += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * kThreads + tid;
      v[u] = j < len ? load(xg, g0 + j, is_bf16) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * kThreads + tid;
      if (j < len && in_smem) data[j] = v[u];
      pmax = max(pmax, abs_bits(v[u]));
    }
  }
  pmax = __reduce_max_sync(0xffffffffu, pmax);
  if (lane == 0) sh.wmax[warp] = pmax;
  __syncthreads();
  if (warp == 0) {
    unsigned m = lane < kWarps ? sh.wmax[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) sh.cmax = m;
  }
  row_sync(slices);                   // every slice's max is published
  unsigned gmax = 0u;
  for (int r = 0; r < slices; ++r) {
    gmax = max(gmax, *peer(&sh.cmax, r, slices));
  }
  const float amax = __uint_as_float(gmax);

  // the bisection, kRadixBits steps a pass
  float lo = 0.0f, hi = __fadd_rn(amax, 1e-12f);
  if (iters > 0) build_midpoints(sh.mid[0], lo, hi, min(kRadixBits, iters));
  __syncthreads();
  for (int done = 0, pass = 0; done < iters; done += kRadixBits, ++pass) {
    const int depth = min(kRadixBits, iters - done);
    const int nb = 1 << depth;
    const float* mid = sh.mid[pass & 1];
    const float inv = hi > lo ? __fdiv_rn((float)nb, __fsub_rn(hi, lo))
                              : 0.0f;
    // bin each |x| in [lo, hi) (bin 0, below every midpoint, counts
    // nowhere and is not recorded); |x| >= hi is above every midpoint
    unsigned above = 0u;
    unsigned* h = sh.hist[pass & 1];
    for (int base = 0; base < len; base += kBatch * kThreads) {
      float a[kBatch];
      int e[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = base + u * kThreads + tid;
        a[u] = j < len ? fabsf(at(j)) : -1.0f;
      }
      bool in[kBatch], any = false;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        above += a[u] >= hi;
        in[u] = a[u] >= lo && a[u] < hi;
        any |= in[u];
      }
      // after the first pass (lo, hi) is narrow: most warps skip
      if (!__any_sync(0xffffffffu, any)) continue;
      int t[kBatch];
      bool slow = false;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int est = __float2int_rd(__fmul_rn(__fsub_rn(a[u], lo), inv));
        e[u] = min(max(est, 0), nb - 1);
        t[u] = in[u] ? bin_near(a[u], e[u], mid, nb) : 0;
        slow |= t[u] < 0;
      }
      if (slow) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (t[u] < 0) t[u] = bin_search(a[u], e[u], mid, nb);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (t[u] > 0) atomicAdd(&h[t[u]], 1u);
      }
    }
    above = __reduce_add_sync(0xffffffffu, above);
    if (lane == 0 && above) atomicAdd(&h[nb - 1], above);
    // (h's last readers, of two passes ago, passed the previous barrier)
    row_sync(slices);                 // every slice's histogram is complete
    // the other buffer's last readers passed the barrier: zero it for the
    // next pass
    for (int b = tid; b < kBins; b += kThreads) {
      sh.hist[(pass + 1) & 1][b] = 0u;
    }
    const unsigned* tot = h;
    if (slices > 1) {
      for (int b = tid; b < nb; b += kThreads) {
        unsigned t = 0u;
        for (int r = 0; r < slices; ++r) t += peer(h, r, slices)[b];
        sh.tot[b] = t;
      }
      tot = sh.tot;
      __syncthreads();
    }
    if (warp == 0) {
      // The count at midpoint j is the sum of the bins from j up.  It
      // falls as j grows, so the sequential loop's decisions down the tree
      // (keep mid[j] as lo iff count / block > p_s in f32, i.e. count >=
      // need, the least such count: topk_quant.py::least_kept_count)
      // end between the last midpoint kept and the first not kept: (lo,
      // hi) = (mid[K], mid[K + 1]) with K the number of midpoints kept.
      // Lane i owns bins [per * i, per * i + per).
      const int per = nb >= 32 ? nb / 32 : 1;
      const int b0 = lane * per;
      unsigned own = 0u;
      if (b0 < nb) {
        for (int b = 0; b < per; ++b) own += tot[b0 + b];
      }
      unsigned suf = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += v;
      }
      int kept = 0;
      if (b0 < nb) {
        unsigned s = suf - own;       // in bins >= b0 + per
        for (int b = per - 1; b >= 0; --b) {
          s += tot[b0 + b];           // values >= mid[b0 + b]
          kept += b0 + b > 0 && s >= (unsigned)need;
        }
      }
      kept = __reduce_add_sync(0xffffffffu, kept);
      if (lane == 0) sh.keep = kept;
    }
    __syncthreads();
    lo = mid[sh.keep];
    hi = mid[sh.keep + 1];
    if (done + depth < iters) {
      build_midpoints(sh.mid[(pass + 1) & 1], lo, hi,
                      min(kRadixBits, iters - done - depth));
      __syncthreads();
    }
  }
  // no peer reads this CTA's shared memory after this point: arrive now,
  // wait before exiting
  if (slices > 1) asm volatile("barrier.cluster.arrive.aligned;\n" : :);

  // quantize and store, 4 neighbouring values a thread (one 4-byte store
  // where the row's levels are aligned); the pad's levels are zeros
  const float thr = keep_all ? 0.0f : midpoint(lo, hi);
  const float scale = fmaxf(amax >= thr ? amax : 0.0f, 1e-12f);
  const int plen = s1 - s0;
  if constexpr (kChannel) {
    // the dequantized values into the leaf (a row has no pad: plen == len)
    const bool quant = bits < 32;
    const float L = quant ? (float)((1 << (bits - 1)) - 1) : 1.0f;
    const float inv_l = __fdiv_rn(1.0f, L);
    const long long o0 = row_start + s0;
    float* of = reinterpret_cast<float*>(leaves.out[lf]) + o0;
    unsigned short* oh =
        reinterpret_cast<unsigned short*>(leaves.out[lf]) + o0;
    const bool of4 = !is_bf16 && (reinterpret_cast<uintptr_t>(of) & 15) == 0;
    // the wire: levels beside the values, the row's scale
    int8_t* ol = kWire ? leaves.lvl[lf] + o0 : nullptr;
    const bool ol4 = kWire && (reinterpret_cast<uintptr_t>(ol) & 3) == 0;
    for (int j = 4 * tid; j < plen; j += 4 * kThreads) {
      float v[4];
      if (in_smem && j + 4 <= len) {
        const float4 f = *reinterpret_cast<const float4*>(data + j);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = j + u < len ? at(j + u) : 0.0f;
      }
      float o[4], q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        o[u] = channel_value(v[u], thr, scale, L, inv_l, quant, &q[u]);
      }
      if constexpr (kWire) {
        if (ol4 && j + 4 <= plen) {
          *reinterpret_cast<unsigned*>(ol + j) =
              ((int)q[0] & 0xff) | ((int)q[1] & 0xff) << 8 |
              ((int)q[2] & 0xff) << 16 | (unsigned)((int)q[3] & 0xff) << 24;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (j + u < plen) ol[j + u] = (int8_t)(int)q[u];
          }
        }
      }
      if (of4 && j + 4 <= plen) {
        *reinterpret_cast<float4*>(of + j) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u < plen) {
            if (is_bf16) {
              oh[j + u] = to_bf16(o[u]);
            } else {
              of[j + u] = o[u];
            }
          }
        }
      }
    }
    if (kWire && rank == 0 && tid == 0) scales[row] = scale;
    if (slices > 1) asm volatile("barrier.cluster.wait.aligned;\n" : :);
    return;
  }
  const float L = (float)((1 << (bits - 1)) - 1);
  int8_t* out = levels + row * (long long)block + s0;
  const bool out4 = (reinterpret_cast<uintptr_t>(out) & 3) == 0;
  for (int j = 4 * tid; j < plen; j += 4 * kThreads) {
    float v[4];
    if (in_smem && j + 4 <= len) {
      const float4 f = *reinterpret_cast<const float4*>(data + j);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = j + u < len ? at(j + u) : 0.0f;
    }
    int q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = quantize(v[u], thr, scale, L);
    if (out4 && j + 4 <= plen) {
      *reinterpret_cast<unsigned*>(out + j) =
          (q[0] & 0xff) | (q[1] & 0xff) << 8 | (q[2] & 0xff) << 16 |
          (unsigned)(q[3] & 0xff) << 24;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < plen) out[j + u] = (int8_t)q[u];
      }
    }
  }
  if (rank == 0 && tid == 0) scales[row] = scale;
  if (slices > 1) asm volatile("barrier.cluster.wait.aligned;\n" : :);
}

// the dynamic shared memory of a launch, set once per process
cudaError_t configure_once() {
  static cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        topk_quant_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxDynSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        topk_quant_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxDynSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(topk_quant_kernel<true, true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kMaxDynSmem);
  }();
  return status;
}

// One launch of either form: rows * slices CTAs of kThreads, clusters of
// `slices`, smem_cap floats of dynamic shared memory a CTA.
template <bool kChannel, bool kWire = false>
cudaError_t launch(const Leaves& lv, int rows, int is_bf16, int block,
                   int slices, int need, int bits, int iters, int smem_cap,
                   int keep_all, void* levels, void* scales, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * slices));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_cap * 4;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, topk_quant_kernel<kChannel, kWire>, lv, is_bf16, block, slices,
      need, bits, iters, smem_cap, keep_all,
      reinterpret_cast<int8_t*>(levels), reinterpret_cast<float*>(scales));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The channel form's wide route: a row of at least WIDE_MIN values
// (kernels/topk_quant.py) is cut into tiles of `tile_len` values, one CTA
// each, in one grid over every row of the launch, so that a long row uses
// the whole card and not one cluster (the plan's tile, wide_tile_len: the
// power of two at or above a 256th of the entry's values, 8,192 to
// 131,072, about one CTA for each of the card's 264 resident slots; a
// larger tile merges fewer histograms, a smaller one fills the card).
// Every pass over a long row reads it from device memory, so a pass takes
// kWideBits = 12 bisection steps (the 4,095 midpoints of a 12-level tree)
// where the cluster route takes 8: at the channel's 12 steps a row is read
// three times (its max, one histogram pass, the store) and written once,
// 16 bytes a f32 value against the bound's 8.  A row's state lives in a
// device workspace, `stride` u32 a row: its max |x| bits, lo and hi as f32
// bits, then per pass kWideBins bins and a ticket.  In stream order, the
// workspace zeroed first:
//   max:   each CTA's max |x| pattern, atomicMax into the row's (exact:
//          non-negative floats order as their u32 patterns);
//   pass:  ceil(iters / 12) times, each CTA builds the pass's midpoints
//          from the row's (lo, hi) with the sequential loop's f32
//          recursion, bins its tile by the number of midpoints <= |x|
//          (bin_batch), and adds its histogram into the row's bins; the
//          last CTA of the row to take a ticket finds K from the row's
//          bins (integer counts: the order of the sums does not matter)
//          and writes (mid[K], mid[K + 1]) as the row's (lo, hi);
//   store: the dequantized values (and the wire) from the row's final
//          (lo, hi) and max, as the cluster route writes them.
// Each reads its tile with 16-byte loads (scalar loads before the first
// 16-byte boundary and after the last), 16 values a thread, the pass
// loading the next 16 before binning these.  kept_midpoints repeats the
// cluster kernel's walk of the decisions, which stays as it is (the block
// form shares that kernel).
// ---------------------------------------------------------------------
constexpr int kWideBits = 12;                 // bisection steps a pass
constexpr int kWideBins = 1 << kWideBits;
constexpr int kWsHead = 4;                    // max |x| bits, lo, hi, pad
constexpr int kWsPass = kWideBins + 4;        // the bins, a ticket, pad
constexpr int kInFlight = 16;                 // values a thread loads

__host__ __device__ __forceinline__ int wide_passes(int iters) {
  return (iters + kWideBits - 1) / kWideBits;
}

__host__ __device__ __forceinline__ int ws_stride(int iters) {
  return kWsHead + wide_passes(iters) * kWsPass;
}

// The leaves of one wide launch: data pointer, output (and level buffer),
// first tile, first row in the launch, row length, need.
struct WideLeaves {
  const void* x[kMaxLeaves];
  void* out[kMaxLeaves];
  int8_t* lvl[kMaxLeaves];
  long long first_tile[kMaxLeaves];
  int first_row[kMaxLeaves];
  int len[kMaxLeaves];
  int need[kMaxLeaves];
  int count;
};

// This CTA's tile: its leaf, its row in the launch, its length, its number
// in the row, the row's tiles, its first value in the leaf.
struct Tile {
  int lf, row, len, tile, tiles;
  long long g0;
};

__device__ __forceinline__ Tile wide_tile(const WideLeaves& lv,
                                          int tile_len) {
  const long long b = blockIdx.x;
  int lf = 0;
  for (int step = kMaxLeaves / 2; step > 0; step >>= 1) {
    if (lf + step < lv.count && lv.first_tile[lf + step] <= b) lf += step;
  }
  const long long n = lv.len[lf];
  const long long tiles = (n + tile_len - 1) / tile_len;
  const long long local = b - lv.first_tile[lf];
  const long long r = local / tiles, t = local - r * tiles;
  Tile o;
  o.lf = lf;
  o.row = lv.first_row[lf] + (int)r;
  o.g0 = r * n + t * tile_len;
  o.len = (int)min((long long)tile_len, n - t * tile_len);
  o.tile = (int)t;
  o.tiles = (int)tiles;
  return o;
}

// A tile's values as `head` scalars up to the first 16-byte boundary,
// `nvec` 16-byte vectors of kVW values, and the scalars after them; the
// scalars are indexed 0 .. n_scalar - 1 (scalar()).
template <bool kBf16>
struct Span {
  static constexpr int kEsz = kBf16 ? 2 : 4;
  static constexpr int kVW = 16 / kEsz;
  const char* p;    // the tile's first value
  int head, nvec, len;
  __device__ __forceinline__ Span(const void* x, long long g0, int n)
      : p(reinterpret_cast<const char*>(x) + g0 * kEsz), len(n) {
    head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                        kEsz));
    nvec = (n - head) / kVW;
  }
  __device__ __forceinline__ int n_scalar() const {
    return len - nvec * kVW;
  }
  __device__ __forceinline__ int scalar(int s) const {   // its index j
    return s < head ? s : s + nvec * kVW;
  }
  __device__ __forceinline__ float at(int j) const {
    if (kBf16) {
      const unsigned short h = reinterpret_cast<const unsigned short*>(p)[j];
      return __uint_as_float(((unsigned)h) << 16);
    }
    return __ldg(reinterpret_cast<const float*>(p) + j);
  }
  // vector i, or NaNs past the last (they bin nowhere)
  __device__ __forceinline__ uint4 vec(int i) const {
    return i < nvec ? __ldg(reinterpret_cast<const uint4*>(p + head * kEsz) +
                            i)
                    : make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  // the kVW values of a vector, in order
  static __device__ __forceinline__ void unpack(const uint4& w, float* v) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (kBf16) {
        v[2 * k] = __uint_as_float(u[k] << 16);
        v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      } else {
        v[k] = __uint_as_float(u[k]);
      }
    }
  }
};

// Bin the magnitudes of kBatch values in [lo, hi) into h (a NaN bins
// nowhere): the bin of |x| is the number of midpoints <= |x|, its estimate
// from the position of |x| in [lo, hi) checked against the two midpoints
// around it (a search where they disagree: an interval a few ulps wide);
// |x| >= hi is counted in `above`.  All lanes of the warp call it together.
__device__ __forceinline__ void bin_batch(const float* v, float lo, float hi,
                                          float inv, const float* mid,
                                          int nb, unsigned* h,
                                          unsigned& above) {
  float a[kBatch];
  bool in[kBatch], any = false;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    a[u] = fabsf(v[u]);
    above += a[u] >= hi;
    in[u] = a[u] >= lo && a[u] < hi;
    any |= in[u];
  }
  if (!__any_sync(0xffffffffu, any)) return;
  int t[kBatch], e[kBatch];
  bool slow = false;
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int est = __float2int_rd(__fmul_rn(__fsub_rn(a[u], lo), inv));
    e[u] = min(max(est, 0), nb - 1);
    t[u] = !in[u] ? 0 : mid[e[u]] <= a[u] && a[u] < mid[e[u] + 1] ? e[u]
                                                                  : -1;
    slow |= t[u] < 0;
  }
  if (slow) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (t[u] < 0) t[u] = bin_search(a[u], e[u], mid, nb);
    }
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (t[u] > 0) atomicAdd(&h[t[u]], 1u);
  }
}

// K, the number of midpoints kept, from the row's bins `tot` (warp 0): the
// count at midpoint j is the sum of the bins from j up, and the sequential
// decisions keep mid[j] iff that count >= need (the cluster route's walk).
__device__ __forceinline__ int kept_midpoints(const unsigned* tot, int nb,
                                              int need, int lane) {
  const int per = nb >= 32 ? nb / 32 : 1;
  const int b0 = lane * per;
  unsigned own = 0u;
  if (b0 < nb) {
    for (int b = 0; b < per; ++b) own += tot[b0 + b];
  }
  unsigned suf = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_down_sync(0xffffffffu, suf, o);
    if (lane + o < 32) suf += v;
  }
  int kept = 0;
  if (b0 < nb) {
    unsigned s = suf - own;
    for (int b = per - 1; b >= 0; --b) {
      s += tot[b0 + b];
      kept += b0 + b > 0 && s >= (unsigned)need;
    }
  }
  return __reduce_add_sync(0xffffffffu, kept);
}

// the values of a vector into the output (and the wire), 16-byte stores
// where the output is aligned as the input is
template <bool kBf16, bool kWire>
__device__ __forceinline__ void store_values(const float* v, int n, int j,
                                             bool vec_ok, bool lvl_ok,
                                             float thr, float scale,
                                             float L, float inv_l,
                                             bool quant, void* out,
                                             int8_t* lvl) {
  float o[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < n) o[k] = channel_value(v[k], thr, scale, L, inv_l, quant, &q[k]);
  }
  if (kBf16) {
    unsigned short* oh = reinterpret_cast<unsigned short*>(out) + j;
    if (vec_ok && n == 8) {
      *reinterpret_cast<uint4*>(oh) = make_uint4(
          to_bf16(o[0]) | (unsigned)to_bf16(o[1]) << 16,
          to_bf16(o[2]) | (unsigned)to_bf16(o[3]) << 16,
          to_bf16(o[4]) | (unsigned)to_bf16(o[5]) << 16,
          to_bf16(o[6]) | (unsigned)to_bf16(o[7]) << 16);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < n) oh[k] = to_bf16(o[k]);
      }
    }
  } else {
    float* of = reinterpret_cast<float*>(out) + j;
    if (vec_ok && n == 4) {
      *reinterpret_cast<float4*>(of) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < n) of[k] = o[k];
      }
    }
  }
  if (kWire) {
    int8_t* ol = lvl + j;
    unsigned b[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k < n) b[k >> 2] |= (unsigned)((int)q[k] & 0xff) << (8 * (k & 3));
    }
    if (lvl_ok && n == (kBf16 ? 8 : 4)) {
      if (kBf16) {
        *reinterpret_cast<uint2*>(ol) = make_uint2(b[0], b[1]);
      } else {
        *reinterpret_cast<unsigned*>(ol) = b[0];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < n) ol[k] = (int8_t)(int)q[k];
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
topk_quant_wide_max(const __grid_constant__ WideLeaves lv, int tile_len,
                    unsigned* __restrict__ ws, int stride) {
  using S = Span<kBf16>;
  constexpr int kVecs = kInFlight / S::kVW;
  __shared__ unsigned wmax[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tl = wide_tile(lv, tile_len);
  const S sp(lv.x[tl.lf], tl.g0, tl.len);
  unsigned m = 0u;
  for (int i0 = 0; i0 < sp.nvec; i0 += kVecs * kThreads) {
    uint4 w[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = i0 + u * kThreads + tid;
      w[u] = i < sp.nvec ? sp.vec(i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      float v[S::kVW];
      S::unpack(w[u], v);
#pragma unroll
      for (int k = 0; k < S::kVW; ++k) m = max(m, abs_bits(v[k]));
    }
  }
  if (tid < sp.n_scalar()) m = max(m, abs_bits(sp.at(sp.scalar(tid))));
  m = __reduce_max_sync(0xffffffffu, m);
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_max_sync(0xffffffffu, lane < kWarps ? wmax[lane] : 0u);
    if (lane == 0 && m) atomicMax(ws + (long long)tl.row * stride, m);
  }
}

// One histogram pass (kFirst: the first, from the row's max; a separate
// instance so that the profiler tells it from the later ones).
template <bool kBf16, bool kFirst>
__global__ void __launch_bounds__(kThreads, 2)
topk_quant_wide_pass(const __grid_constant__ WideLeaves lv, int tile_len,
                     int pass, int iters, unsigned* __restrict__ ws,
                     int stride) {
  using S = Span<kBf16>;
  constexpr int kVecs = kInFlight / S::kVW;
  __shared__ unsigned hist[kWideBins];
  __shared__ float mid[kWideBins + 1];
  __shared__ int last, keep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tl = wide_tile(lv, tile_len);
  unsigned* st = ws + (long long)tl.row * stride;
  float lo = 0.0f, hi = __fadd_rn(__uint_as_float(st[0]), 1e-12f);
  if (!kFirst) {
    lo = __uint_as_float(st[1]);
    hi = __uint_as_float(st[2]);
  }
  const int depth = min(kWideBits, iters - pass * kWideBits);
  const int nb = 1 << depth;
  build_midpoints(mid, lo, hi, depth);
  for (int b = tid; b < nb; b += kThreads) hist[b] = 0u;
  __syncthreads();
  const float inv = hi > lo ? __fdiv_rn((float)nb, __fsub_rn(hi, lo)) : 0.0f;
  const S sp(lv.x[tl.lf], tl.g0, tl.len);
  unsigned above = 0u;
  uint4 w[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) w[u] = sp.vec(u * kThreads + tid);
  for (int i0 = 0; i0 < sp.nvec; i0 += kVecs * kThreads) {
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) S::unpack(w[u], v + u * S::kVW);
    // the next vectors are in flight while these are binned
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      w[u] = sp.vec(i0 + (kVecs + u) * kThreads + tid);
    }
#pragma unroll
    for (int c = 0; c < kInFlight; c += kBatch) {
      bin_batch(v + c, lo, hi, inv, mid, nb, hist, above);
    }
  }
  {
    float v[kBatch];
    v[0] = tid < sp.n_scalar() ? sp.at(sp.scalar(tid)) : __uint_as_float(~0u);
#pragma unroll
    for (int u = 1; u < kBatch; ++u) v[u] = __uint_as_float(~0u);
    bin_batch(v, lo, hi, inv, mid, nb, hist, above);
  }
  above = __reduce_add_sync(0xffffffffu, above);
  if (lane == 0 && above) atomicAdd(&hist[nb - 1], above);
  __syncthreads();
  unsigned* bins = st + kWsHead + pass * kWsPass;
  for (int b = tid; b < nb; b += kThreads) {
    if (hist[b]) atomicAdd(&bins[b], hist[b]);
  }
  __threadfence();       // this CTA's sums are visible before its ticket
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&bins[kWideBins], 1u) == (unsigned)(tl.tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  // every tile of the row has added its bins: decide the pass
  __threadfence();
  for (int b = tid; b < nb; b += kThreads) hist[b] = __ldcg(bins + b);
  __syncthreads();
  if (warp == 0) {
    const int k = kept_midpoints(hist, nb, lv.need[tl.lf], lane);
    if (lane == 0) keep = k;
  }
  __syncthreads();
  if (tid == 0) {
    st[1] = __float_as_uint(mid[keep]);
    st[2] = __float_as_uint(mid[keep + 1]);
  }
}

template <bool kBf16, bool kWire>
__global__ void __launch_bounds__(kThreads, 2)
topk_quant_wide_store(const __grid_constant__ WideLeaves lv, int tile_len,
                      int iters, int keep_all, int bits,
                      const unsigned* __restrict__ ws, int stride,
                      float* __restrict__ scales) {
  using S = Span<kBf16>;
  constexpr int kVecs = kInFlight / S::kVW;
  const int tid = threadIdx.x;
  const Tile tl = wide_tile(lv, tile_len);
  const unsigned* st = ws + (long long)tl.row * stride;
  const float amax = __uint_as_float(st[0]);
  float lo = 0.0f, hi = __fadd_rn(amax, 1e-12f);
  if (iters > 0) {
    lo = __uint_as_float(st[1]);
    hi = __uint_as_float(st[2]);
  }
  const float thr = keep_all ? 0.0f : midpoint(lo, hi);
  const float scale = fmaxf(amax >= thr ? amax : 0.0f, 1e-12f);
  if (kWire && tl.tile == 0 && tid == 0) scales[tl.row] = scale;
  const bool quant = bits < 32;
  const float L = quant ? (float)((1 << (bits - 1)) - 1) : 1.0f;
  const float inv_l = __fdiv_rn(1.0f, L);
  const S sp(lv.x[tl.lf], tl.g0, tl.len);
  char* out = reinterpret_cast<char*>(lv.out[tl.lf]) + tl.g0 * S::kEsz;
  int8_t* lvl = kWire ? lv.lvl[tl.lf] + tl.g0 : nullptr;
  // the vectors' outputs are 16-byte (levels 4- or 8-byte) aligned
  const bool vec_ok =
      ((reinterpret_cast<uintptr_t>(out) + sp.head * S::kEsz) & 15) == 0;
  const bool lvl_ok =
      kWire && ((reinterpret_cast<uintptr_t>(lvl) + sp.head) &
                (S::kVW - 1)) == 0;
  for (int i0 = 0; i0 < sp.nvec; i0 += kVecs * kThreads) {
    uint4 w[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) w[u] = sp.vec(i0 + u * kThreads + tid);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = i0 + u * kThreads + tid;
      if (i < sp.nvec) {
        float v[S::kVW];
        S::unpack(w[u], v);
        store_values<kBf16, kWire>(v, S::kVW, sp.head + i * S::kVW, vec_ok,
                                   lvl_ok, thr, scale, L, inv_l, quant, out,
                                   lvl);
      }
    }
  }
  if (tid < sp.n_scalar()) {
    const int j = sp.scalar(tid);
    const float v = sp.at(j);
    store_values<kBf16, kWire>(&v, 1, j, false, false, thr, scale, L, inv_l,
                               quant, out, lvl);
  }
}

// One wide launch: the workspace's rows zeroed, the max, the passes, the
// store, on `stream`; `scales` (rows of the launch) asks for the wire.
template <bool kBf16, bool kWire>
cudaError_t wide_launch(const WideLeaves& lv, long long tiles, int rows,
                        int tile_len, int iters, int keep_all, int bits,
                        unsigned* ws, float* scales, cudaStream_t stream) {
  if (keep_all) iters = 0;
  const int stride = ws_stride(iters);
  cudaError_t err = cudaMemsetAsync(
      ws, 0, (size_t)rows * stride * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles);
  topk_quant_wide_max<kBf16><<<grid, kThreads, 0, stream>>>(lv, tile_len, ws,
                                                            stride);
  err = cudaGetLastError();
  for (int pass = 0; err == cudaSuccess && pass < wide_passes(iters);
       ++pass) {
    if (pass == 0) {
      topk_quant_wide_pass<kBf16, true><<<grid, kThreads, 0, stream>>>(
          lv, tile_len, pass, iters, ws, stride);
    } else {
      topk_quant_wide_pass<kBf16, false><<<grid, kThreads, 0, stream>>>(
          lv, tile_len, pass, iters, ws, stride);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  topk_quant_wide_store<kBf16, kWire><<<grid, kThreads, 0, stream>>>(
      lv, tile_len, iters, keep_all, bits, ws, stride, scales);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Compress the rows of n_leaves leaves (f32, or bf16 when is_bf16) into
// int8 levels (rows of `block`) and f32 scales, one launch on `stream`.
// Leaf i has ns[i] values at ptrs[i] and its rows start at output row
// firsts[i]; the launch writes `rows` rows from firsts[0] on.  Each row
// takes `slices` CTAs of one cluster (1 to kCluster).  A midpoint is kept
// as lo when at least `need` values of its row are >= it (the least count
// c with c / block > p_s in f32).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int topk_quant_launch(int n_leaves, const long long* ptrs,
                      const long long* ns, const long long* firsts, int rows,
                      int is_bf16, int block, int slices, int need, int bits,
                      int iters, void* levels, void* scales, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || rows < 1 || block < 1 ||
      slices < 1 || slices > kCluster || need < 0 || bits < 2 || bits > 8 ||
      iters < 0 || (long long)rows * slices > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  Leaves lv = {};
  for (int i = 0; i < n_leaves; ++i) {
    lv.x[i] = reinterpret_cast<const void*>(ptrs[i]);
    lv.n[i] = ns[i];
    lv.first[i] = firsts[i];
  }
  lv.count = n_leaves;
  const int part = slice_len(block, slices);
  return (int)launch<false>(lv, rows, is_bf16, block, slices, need, bits,
                            iters, part <= kMaxSlice ? part : 0, 0, levels,
                            scales, stream);
}

// The channel form over the leaves of a plan (kernels/topk_quant.py::
// _channel_layout), every launch of it on `stream`:
//   plan = [entries, then per entry: slices (0: the wide route), leaves,
//           rows, tiles, workspace row, first scale row, tile length,
//           then per leaf: its index in xptrs, values, row length, need,
//           first row in the entry, first tile, offset of its output]
// Leaf i's values are at xptrs[index] (f32, or bf16 when is_bf16), cut
// into rows of its row length; its values are written at `out` + offset
// (same dtype, same layout) and, where `lvl` is not null (the wire, bits
// 2..8), its int8 levels at `lvl` + offset and each row's f32 scale at
// `scales` + the entry's first scale row + the row's number in the entry.
// A cluster entry takes one launch of `slices` CTAs a row; a wide entry
// takes tiles of its tile length and its rows' state in `ws`
// (`ws_stride(iters)` u32 a row from its workspace row, `ws_words` in
// all).  A midpoint is kept as lo when at least `need` values of its row
// are >= it (the least count c with c * f32(1/len) > p_s in f32).  bits is
// 2..16, or 32 for no quantization; keep_all (p_s >= 1) keeps every value
// without a search.  Returns the first CUDA error, or
// cudaErrorInvalidValue for arguments the kernels do not take (before
// anything is launched).
int topk_channel_run(const long long* plan, const long long* xptrs,
                     void* out, void* lvl, void* scales, void* ws,
                     long long ws_words, int is_bf16, int bits, int iters,
                     int keep_all, void* stream) {
  if (!((bits >= 2 && bits <= 16) || bits == 32) || iters < 0 ||
      (lvl && (bits > 8 || !scales))) {
    return (int)cudaErrorInvalidValue;
  }
  const int stride = ws_stride(keep_all ? 0 : iters);
  constexpr int kHead = 7, kLeaf = 7;     // table words an entry, a leaf
  // the whole plan is checked before the first launch
  const long long n_entries = plan[0];
  const long long* p = plan + 1;
  for (long long e = 0; e < n_entries; ++e) {
    const long long slices = p[0], k = p[1], rows = p[2], tiles = p[3];
    const long long ws_row = p[4], tile_len = p[6];
    if (k < 1 || k > kMaxLeaves || rows < 1 || slices < 0 ||
        slices > kCluster || rows * (slices ? slices : 1) > 0x7fffffffLL ||
        (!slices && (tiles < 1 || tiles > 0x7fffffffLL || tile_len < 1 ||
                     tile_len > 0x7fffffffLL || ws_row < 0 ||
                     (ws_row + rows) * stride > ws_words || !ws))) {
      return (int)cudaErrorInvalidValue;
    }
    for (long long i = 0; i < k; ++i) {
      const long long* q = p + kHead + kLeaf * i;
      if (q[2] < 1 || q[2] > 0x7fffffffLL || q[1] % q[2] != 0 || q[3] < 0 ||
          q[3] > q[2] + 1 || (i == 0 && (q[4] != 0 || q[5] != 0))) {
        return (int)cudaErrorInvalidValue;
      }
    }
    p += kHead + kLeaf * k;
  }
  cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int esz = is_bf16 ? 2 : 4;
  p = plan + 1;
  for (long long e = 0; e < n_entries && err == cudaSuccess; ++e) {
    const int slices = (int)p[0], k = (int)p[1], rows = (int)p[2];
    const long long tiles = p[3], ws_row = p[4];
    float* sc = scales ? reinterpret_cast<float*>(scales) + p[5] : nullptr;
    const int tile_len = (int)p[6];
    const long long* q = p + kHead;
    p += kHead + kLeaf * k;
    if (slices > 0) {
      Leaves lv = {};
      int cap = 0;
      for (int i = 0; i < k; ++i, q += kLeaf) {
        lv.x[i] = reinterpret_cast<const void*>(xptrs[q[0]]);
        lv.out[i] = reinterpret_cast<char*>(out) + q[6] * esz;
        lv.lvl[i] = lvl ? reinterpret_cast<int8_t*>(lvl) + q[6] : nullptr;
        lv.n[i] = q[1];
        lv.len[i] = (int)q[2];
        lv.need[i] = (int)q[3];
        lv.first[i] = q[4];
        const int part = slice_len(lv.len[i], slices);
        if (part <= kMaxSlice && part > cap) cap = part;
      }
      lv.count = k;
      err = lvl ? launch<true, true>(lv, rows, is_bf16, 0, slices, 0, bits,
                                     iters, cap, keep_all, nullptr, sc,
                                     stream)
                : launch<true>(lv, rows, is_bf16, 0, slices, 0, bits, iters,
                               cap, keep_all, nullptr, nullptr, stream);
      continue;
    }
    WideLeaves lv = {};
    for (int i = 0; i < k; ++i, q += kLeaf) {
      lv.x[i] = reinterpret_cast<const void*>(xptrs[q[0]]);
      lv.out[i] = reinterpret_cast<char*>(out) + q[6] * esz;
      lv.lvl[i] = lvl ? reinterpret_cast<int8_t*>(lvl) + q[6] : nullptr;
      lv.len[i] = (int)q[2];
      lv.need[i] = (int)q[3];
      lv.first_row[i] = (int)q[4];
      lv.first_tile[i] = q[5];
    }
    lv.count = k;
    unsigned* w = reinterpret_cast<unsigned*>(ws) + ws_row * stride;
    if (is_bf16) {
      err = sc ? wide_launch<true, true>(lv, tiles, rows, tile_len, iters,
                                         keep_all, bits, w, sc, s)
               : wide_launch<true, false>(lv, tiles, rows, tile_len, iters,
                                          keep_all, bits, w, sc, s);
    } else {
      err = sc ? wide_launch<false, true>(lv, tiles, rows, tile_len, iters,
                                          keep_all, bits, w, sc, s)
               : wide_launch<false, false>(lv, tiles, rows, tile_len, iters,
                                           keep_all, bits, w, sc, s);
    }
  }
  return (int)err;
}

}  // extern "C"
