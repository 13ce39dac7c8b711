// ssd_scan.cu -- the Mamba2 SSD intra-chunk step (kernel C).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_intra_chunk (the pallas_call
// at :58, body _kernel :22) of the JAX package.
//
// What it computes, per grid cell g (one batch row, chunk and head; cells
// ordered (batch, chunk, head)), with f32 accumulation:
//   CB = C Bt                                    (L x L)
//   y  = (CB o exp(cum_i - cum_j) [i >= j]) Xb    (L x P)
//   S  = (B o exp(cum[L-1] - cum))t Xb            (N x P)
//   a  = exp(cum[L-1])
// Xb is (G, L, P) f32, cum (G, 1, L) f32; B and C are (G / heads, L, N) in
// f32 or bf16, one copy per (batch, chunk) serving all `heads` cells of it
// (cell g reads row g / heads), so no per-head broadcast is ever made.
//
// What bounds it on an H100: at the serving shape (L=256, P=64, N=128) a
// cell does 2L^2N + 2L^2P + 2LNP = 29.4 MFLOP on 0.17 MB of data, about 170
// FLOP per byte, so it is bound by arithmetic: 28 us for the 64 cells of a
// 512-token prompt at the 67 TFLOP/s f32 rate outside the tensor cores,
// against 3.3 us for the bytes.
//
// What the design does about it: FFMA register tiles fed from shared
// memory, all cells in parallel across CTAs.  The TPU kernel holds a whole
// cell (a 256 KiB L x L score tile among it) in VMEM; a CTA here has at most
// 227 KB, so the L x L product is tiled.  Each CTA owns a 64-row tile of y
// and walks the 64-column tiles at or below the diagonal (tiles above it are
// skipped, never computed): it forms a 64 x 64 score tile C_i B_jt, scales
// it by exp(cum_r - cum_c) where r >= c (the mask sits in the exponent: the
// positive log-decay above the diagonal is never exponentiated), and
// accumulates score x Xb_j into its 64 x P tile of y in registers.  One
// more CTA per cell forms S and a.  CTAs of the longest row tiles launch
// first.  The tensor-core (TF32 wgmma) form is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows of y per CTA; columns per step
constexpr int kPad = 4;              // keeps float4 rows 16-byte aligned
constexpr int kLd = kTile + kPad;    // leading dim of the transposed tiles
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxL = 256, kMaxP = 64, kMaxN = 128;

// floats of dynamic shared memory a launch needs
__host__ __device__ constexpr int smem_floats(int P, int N) {
  // y CTAs: cT (N x kLd), bT (N x kLd), xs (kTile x P), sT (kTile x kLd),
  // cum of the rows and of the columns; the S CTA uses less (bs, xs, ds)
  return 2 * N * kLd + kTile * P + kTile * kLd + 2 * kTile;
}

template <bool kBf16>
__device__ __forceinline__ float load_bc(const void* p, long long i) {
  if (kBf16) {
    // bf16 is the high half of an f32: widening is a shift, exact
    const unsigned short h = reinterpret_cast<const unsigned short*>(p)[i];
    return __uint_as_float(((unsigned)h) << 16);
  }
  return reinterpret_cast<const float*>(p)[i];
}

// One 64-row tile of y for cell g.
template <bool kBf16>
__device__ void y_tile(const float* __restrict__ xb, const void* b,
                       const void* c, const float* __restrict__ cum,
                       int g, int heads, int L, int P, int N, int tile,
                       float* __restrict__ y, float* sm) {
  float* cT = sm;                    // [N][kLd]: C rows of the tile, n-major
  float* bT = cT + N * kLd;          // [N][kLd]: B rows of the column tile
  float* xs = bT + N * kLd;          // [kTile][P]: Xb rows of the column tile
  float* sT = xs + kTile * P;        // [kTile][kLd]: score, column-major
  float* cr = sT + kTile * kLd;      // [kTile]: cum of the rows
  float* cc = cr + kTile;            // [kTile]: cum of the columns

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int r0 = tile * kTile;
  const long long bc0 = (long long)(g / heads) * L * N;
  const float* cumg = cum + (long long)g * L;
  const float* xg = xb + (long long)g * L * P;

  for (int i = tid; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    cT[n * kLd + r] = r0 + r < L ? load_bc<kBf16>(c, bc0 + (long long)(r0 + r) * N + n)
                                 : 0.0f;
  }
  for (int r = tid; r < kTile; r += kThreads) {
    cr[r] = r0 + r < L ? cumg[r0 + r] : 0.0f;
  }

  float acc[4][4];                   // y rows ty*4+i, columns tx+16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int ct = 0; ct <= tile; ++ct) {
    const int c0 = ct * kTile;
    __syncthreads();                 // the last step is done with bT, xs, sT
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int k = i / N, n = i - k * N;
      bT[n * kLd + k] = c0 + k < L ? load_bc<kBf16>(b, bc0 + (long long)(c0 + k) * N + n)
                                   : 0.0f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int k = i / P;
      xs[i] = c0 + k < L ? xg[(long long)c0 * P + i] : 0.0f;
    }
    for (int k = tid; k < kTile; k += kThreads) {
      cc[k] = c0 + k < L ? cumg[c0 + k] : 0.0f;
    }
    __syncthreads();

    // score rows ty*4+i, columns tx+16*j of C_i B_ct^T
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(&cT[n * kLd + ty * 4]);
      const float* brow = &bT[n * kLd + tx];
      const float bv[4] = {brow[0], brow[16], brow[32], brow[48]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] += cv.x * bv[j];
        s[1][j] += cv.y * bv[j];
        s[2][j] += cv.z * bv[j];
        s[3][j] += cv.w * bv[j];
      }
    }
    // decay in the exponent, masked before the exp; stored column-major
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = tx + 16 * j;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const bool keep = c0 + k <= r0 + r && r0 + r < L;
        v[i] = keep ? s[i][j] * expf(cr[r] - cc[k]) : 0.0f;
      }
      *reinterpret_cast<float4*>(&sT[k * kLd + ty * 4]) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

    // y rows ty*4+i, columns tx+16*j += score x Xb_ct
    for (int k = 0; k < kTile; ++k) {
      const float4 sv = *reinterpret_cast<const float4*>(&sT[k * kLd + ty * 4]);
      const float* xrow = &xs[k * P];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        const float xv = p < P ? xrow[p] : 0.0f;
        acc[0][j] += sv.x * xv;
        acc[1][j] += sv.y * xv;
        acc[2][j] += sv.z * xv;
        acc[3][j] += sv.w * xv;
      }
    }
  }

  float* yg = y + (long long)g * L * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) yg[(long long)r * P + p] = acc[i][j];
    }
  }
}

// S (N x P) and a for cell g.
template <bool kBf16>
__device__ void state_tile(const float* __restrict__ xb, const void* b,
                           const float* __restrict__ cum, int g, int heads,
                           int L, int P, int N, float* __restrict__ s,
                           float* __restrict__ a, float* sm) {
  float* bs = sm;                    // [kTile][N]: B rows x decay to the end
  float* xs = bs + kTile * N;        // [kTile][P]
  float* ds = xs + kTile * P;        // [kTile]: decay to the end
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const long long bc0 = (long long)(g / heads) * L * N;
  const float* cumg = cum + (long long)g * L;
  const float* xg = xb + (long long)g * L * P;
  const float last = cumg[L - 1];

  float acc[8][4];                   // S rows ty+16*i, columns tx+16*j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int l0 = 0; l0 < L; l0 += kTile) {
    __syncthreads();
    for (int l = tid; l < kTile; l += kThreads) {
      ds[l] = l0 + l < L ? expf(last - cumg[l0 + l]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int l = i / N;
      bs[i] = l0 + l < L ? load_bc<kBf16>(b, bc0 + (long long)l0 * N + i) * ds[l]
                         : 0.0f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int l = i / P;
      xs[i] = l0 + l < L ? xg[(long long)l0 * P + i] : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < kTile; ++l) {
      float bv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = ty + 16 * i;
        bv[i] = n < N ? bs[l * N + n] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        xv[j] = p < P ? xs[l * P + p] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += bv[i] * xv[j];
    }
  }

  float* sg = s + (long long)g * N * P;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) sg[(long long)n * P + p] = acc[i][j];
    }
  }
  if (tid == 0) a[g] = expf(last);
}

// grid (G, row tiles + 1): blockIdx.y < row tiles -> a tile of y, the
// longest (bottom) tiles first; the last -> S and a
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xb, const void* __restrict__ b,
                const void* __restrict__ c, const float* __restrict__ cum,
                int heads, int L, int P, int N, float* __restrict__ y,
                float* __restrict__ s, float* __restrict__ a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int g = blockIdx.x;
  const int n_tiles = (L + kTile - 1) / kTile;
  if ((int)blockIdx.y < n_tiles) {
    y_tile<kBf16>(xb, b, c, cum, g, heads, L, P, N,
                  n_tiles - 1 - (int)blockIdx.y, y, sm);
  } else {
    state_tile<kBf16>(xb, b, cum, g, heads, L, P, N, s, a, sm);
  }
}

// the largest dynamic shared memory any launch asks for, set once
cudaError_t configure_once() {
  static cudaError_t status = [] {
    const int bytes = smem_floats(kMaxP, kMaxN) * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(ssd_scan_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
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
    const dim3 grid(G, (L + kTile - 1) / kTile + 1);
    const size_t smem = (size_t)smem_floats(P, N) * sizeof(float);
    const cudaStream_t st = (cudaStream_t)stream;
    const float* x = reinterpret_cast<const float*>(xb);
    const float* cm = reinterpret_cast<const float*>(cum);
    float* yo = reinterpret_cast<float*>(y);
    float* so = reinterpret_cast<float*>(s);
    float* ao = reinterpret_cast<float*>(a);
    if (bc_bf16) {
      ssd_scan_kernel<true><<<grid, kThreads, smem, st>>>(
          x, b, c, cm, heads, L, P, N, yo, so, ao);
    } else {
      ssd_scan_kernel<false><<<grid, kThreads, smem, st>>>(
          x, b, c, cm, heads, L, P, N, yo, so, ao);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
