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
// The channel form (topk_channel_launch; the same kernel, kChannel = true)
// is the cohort trainer's threshold channel: src/repro/core/compression.py
// ::sparsify_quantize_threshold (:98) under jax.vmap over a leaf's leading
// device axis, as jax.jit compiles it.  Each row is one device's leaf, of
// its own length with no pad; the leaf table adds each leaf's row length,
// its need and its output.  Differences from the block form:
// * XLA multiplies by the f32 reciprocal of a constant divisor, so the kept
//   fraction is count * f32(1/len) (the wrapper's need follows that rule,
//   kernels/topk_quant.py::channel_need) and the value written is
//   (level * scale) * f32(1/L), in the leaf's dtype and layout, 0 where
//   dropped; levels stay f32 in registers, so bits 2..16 are taken, and
//   bits = 32 writes x where kept;
// * keep_all (p_s >= 1) skips the search and keeps every value;
// * one launch per cluster size: the wrapper groups leaves by the CTAs a
//   row takes, so the CNN's 8 leaves take 2 launches (fc1's rows on 8-CTA
//   clusters, the other seven one CTA a row).
// * on request it also writes the wire of the federated round's mesh
//   branch (src/repro/core/fed_step.py::compress_delta, :81): each value's
//   int8 level (0 where dropped) into the leaf's level buffer and each
//   row's f32 scale, indexed by the row's number in the launch; bits 2..8.

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

// The channel form over n_leaves leaves (f32, or bf16 when is_bf16), one
// launch on `stream`: leaf i has ns[i] values at ptrs[i], cut into rows of
// lens[i] (ns[i] a multiple of it), its rows numbered from firsts[i] in
// the launch (firsts[0] = 0, `rows` in all), and its values written to
// outs[i], same dtype and layout.  Each row takes `slices` CTAs of one
// cluster; a midpoint is kept as lo when at least needs[i] values of the
// row are >= it (the least count c with c * f32(1/lens[i]) > p_s in f32).
// bits is 2..16, or 32 for no quantization; keep_all (p_s >= 1) keeps
// every value without a search.  With lvls not null (bits 2..8) it also
// writes each value's int8 level to lvls[i] (the leaf's layout) and each
// row's f32 scale to scales[row], rows numbered in the launch.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int topk_channel_launch(int n_leaves, const long long* ptrs,
                        const long long* outs, const long long* ns,
                        const long long* lens, const long long* needs,
                        const long long* firsts, int rows, int is_bf16,
                        int slices, int bits, int iters, int keep_all,
                        const long long* lvls, void* scales, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || rows < 1 || slices < 1 ||
      slices > kCluster || !((bits >= 2 && bits <= 16) || bits == 32) ||
      iters < 0 || (long long)rows * slices > 0x7fffffffLL ||
      firsts[0] != 0 || (lvls && (bits > 8 || !scales))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = configure_once();
  if (err != cudaSuccess) return (int)err;
  Leaves lv = {};
  int cap = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (lens[i] < 1 || lens[i] > 0x7fffffffLL || ns[i] % lens[i] != 0 ||
        needs[i] < 0 || needs[i] > lens[i] + 1) {
      return (int)cudaErrorInvalidValue;
    }
    lv.x[i] = reinterpret_cast<const void*>(ptrs[i]);
    lv.out[i] = reinterpret_cast<void*>(outs[i]);
    lv.n[i] = ns[i];
    lv.first[i] = firsts[i];
    lv.len[i] = (int)lens[i];
    lv.need[i] = (int)needs[i];
    lv.lvl[i] = lvls ? reinterpret_cast<int8_t*>(lvls[i]) : nullptr;
    const int part = slice_len(lv.len[i], slices);
    if (part <= kMaxSlice && part > cap) cap = part;
  }
  lv.count = n_leaves;
  if (lvls) {
    return (int)launch<true, true>(lv, rows, is_bf16, 0, slices, 0, bits,
                                   iters, cap, keep_all, nullptr, scales,
                                   stream);
  }
  return (int)launch<true>(lv, rows, is_bf16, 0, slices, 0, bits, iters, cap,
                           keep_all, nullptr, nullptr, stream);
}

}  // extern "C"
