// topk_quant.cu -- block-local threshold Top-K plus symmetric quantization.
//
// Replaces: src/repro/kernels/topk_quant.py::topk_quant (the pallas_call at
// :75, body _kernel :33) of the JAX package.
//
// What it computes, per zero-padded row of `block` values (the padding
// counts in the kept fraction), bit-exact with the JAX kernel and with
// topk_quant_plain in topk_quant.py:
//   1. hi = max|x| + 1e-12, lo = 0, then `iters` bisection steps
//      mid = 0.5 * (lo + hi); keep mid as lo iff mean(|x| >= mid) > p_s;
//   2. thr = 0.5 * (lo + hi); kept = |x| >= thr ? x : 0;
//   3. scale = max(max|kept|, 1e-12); levels = clip(round(kept / scale * L),
//      -L, L) as int8, L = 2^(bits-1) - 1, round half to even.
//
// What bounds it on an H100: a row is 64 KB of f32 at the default block,
// read once and written once as int8, so the data moves in well under a
// microsecond at 3.35 TB/s for the paper's CNN; the kernel is bound by
// latency: the launch and the chain of 18 block-wide reductions per row.
//
// What the design does about it: one CTA per row, with the row held in
// dynamic shared memory (16,384 f32 = 64 KB), so the 16 bisection counts
// and both max passes read shared memory instead of device memory, and
// all rows run in parallel on separate SMs.
//
// Rounding: the mean is count / block in IEEE f32 division.  Counts below
// 2^24 are exact in any order, so for a power-of-two block the mean is
// exact and matches XLA bit for bit.  The other f32 expressions use the
// _rn intrinsics, rintf rounds half to even, and the build passes
// -fmad=false without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_reduce.cuh>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlock = 16384;      // 64 KB of f32 in shared memory

typedef cub::BlockReduce<int, kThreads> ReduceI;
typedef cub::BlockReduce<float, kThreads> ReduceF;

struct Shared {
  union {
    ReduceI::TempStorage ri;
    ReduceF::TempStorage rf;
  } tmp;
  int bcast_i;
  float bcast_f;
};

struct MaxF {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

__device__ __forceinline__ int block_sum(int v, Shared& sh) {
  int tot = ReduceI(sh.tmp.ri).Sum(v);
  if (threadIdx.x == 0) sh.bcast_i = tot;
  __syncthreads();
  tot = sh.bcast_i;
  __syncthreads();
  return tot;
}

__device__ __forceinline__ float block_max(float v, Shared& sh) {
  float m = ReduceF(sh.tmp.rf).Reduce(v, MaxF());
  if (threadIdx.x == 0) sh.bcast_f = m;
  __syncthreads();
  m = sh.bcast_f;
  __syncthreads();
  return m;
}

// bf16 is the high half of an f32: widening is a shift, exact
__device__ __forceinline__ float load(const void* x, long long i,
                                      int is_bf16) {
  if (is_bf16) {
    unsigned short h = reinterpret_cast<const unsigned short*>(x)[i];
    return __uint_as_float(((unsigned)h) << 16);
  }
  return reinterpret_cast<const float*>(x)[i];
}

__global__ void __launch_bounds__(kThreads)
topk_quant_kernel(const void* __restrict__ x, int is_bf16, int block,
                  float p_s, int bits, int iters,
                  int8_t* __restrict__ levels, float* __restrict__ scales) {
  extern __shared__ float row[];
  __shared__ Shared sh;
  const long long base = (long long)blockIdx.x * block;
  const int tid = threadIdx.x;

  float amax = 0.0f;
  for (int i = tid; i < block; i += kThreads) {
    const float v = load(x, base + i, is_bf16);
    row[i] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = block_max(amax, sh);         // its barriers also publish row[]

  float lo = 0.0f;
  float hi = __fadd_rn(amax, 1e-12f);
  const float fblock = (float)block;
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = tid; i < block; i += kThreads) c += fabsf(row[i]) >= mid;
    const float frac = __fdiv_rn((float)block_sum(c, sh), fblock);
    if (frac > p_s) lo = mid; else hi = mid;
  }
  const float thr = __fmul_rn(0.5f, __fadd_rn(lo, hi));

  float kmax = 0.0f;
  for (int i = tid; i < block; i += kThreads) {
    const float a = fabsf(row[i]);
    if (a >= thr) kmax = fmaxf(kmax, a);
  }
  const float scale = fmaxf(block_max(kmax, sh), 1e-12f);
  const float L = (float)((1 << (bits - 1)) - 1);
  for (int i = tid; i < block; i += kThreads) {
    const float v = row[i];
    const float kept = fabsf(v) >= thr ? v : 0.0f;
    float q = rintf(__fmul_rn(__fdiv_rn(kept, scale), L));
    q = fminf(fmaxf(q, -L), L);
    levels[base + i] = (int8_t)(int)q;
  }
  if (tid == 0) scales[blockIdx.x] = scale;
}

}  // namespace

extern "C" {

// Compress m rows of `block` values (f32, or bf16 when is_bf16) into int8
// levels (m, block) and f32 scales (m,), on `stream`.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block the shared
// memory cannot hold.
int topk_quant_launch(const void* x, int is_bf16, int m, int block,
                      float p_s, int bits, int iters, void* levels,
                      void* scales, void* stream) {
  if (block < 1 || block > kMaxBlock || bits < 2 || bits > 8) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)block * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    topk_quant_kernel<<<m, kThreads, smem, (cudaStream_t)stream>>>(
        x, is_bf16, block, p_s, bits, iters,
        reinterpret_cast<int8_t*>(levels), reinterpret_cast<float*>(scales));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
