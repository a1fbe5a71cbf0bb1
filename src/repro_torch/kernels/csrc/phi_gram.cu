// Streaming fused fit: G = Phi^T Phi and b = Phi^T y with Phi never
// written to device memory.  scale != 0 applies the epilogue
// B = I + D G D / sigma^2 in the same kernel.
//
// Replaces two TPU kernels with one source:
//  * repro/kernels/phi_gram.py::phi_gram_kernel (one model; body
//    _phi_gram_body) -- entry repro_phi_gram, a bank of one slot;
//  * repro/kernels/phi_gram.py::bank_phi_gram_kernel (a bank of B
//    independent models; body _bank_phi_gram_body) -- entry
//    repro_bank_phi_gram: unscaled G_s = Phi_s^T Phi_s and
//    b_s = Phi_s^T (mask_s * y_s) for every slot s in one launch;
// with the tile builders hermite_phi.py::phi_tile and rff_phi.py::rff_tile
// inlined.
//
// Bound on the H100: float32 operations on the CUDA cores.  The Gram is
// N*M*(M+1) flops for its upper triangle (4.3e12 flops for the full square
// at N = 10^4, M = 14,641), against a few hundred MB of traffic (read X and
// y once, write B once), so the card's 67 TFLOP/s float32 rate is the
// limit; TF32 tensor cores would be faster but break the 1e-3 parity gates.
//
// For a bank (B slots of N rows, M = 625 at the fleet's shape) the work is
// B*N*M*(M+1) flops (2.0e12 at B = 512, N = 10^4), again far above its
// bytes, so the same float32 rate bounds it.
//
// Design:
//  * The slot is the grid's y axis: block (lin, s) of the bank kernel
//    offsets X, y, mask, the output and b by slot s and computes tile lin
//    of that slot's Gram.  Both kernels share one body (phi_gram_body);
//    the one-model kernel has no offsets.  The offset pointers would cost
//    the body 13 registers (61 instead of 48), cutting occupancy from 5 to
//    4 blocks per SM, so the bank kernel asks for 5 blocks per SM in its
//    launch bounds; that hint makes the one-model kernel slower, so it
//    keeps the plain bound.
//  * One block owns one 64 x 64 output tile and loops over all N rows
//    inside the block, so no sum is carried between blocks: no atomics, no
//    second pass.  This loop takes the place of the TPU's sequential grid
//    axis over N.
//  * G is symmetric, so only tiles (bi <= bj) are launched and the block
//    writes its tile and, off the diagonal, the mirrored tile: half the
//    arithmetic, and B comes out exactly symmetric for the Cholesky.
//  * Per 32-row step the block evaluates each row's p*n Hermite values once
//    into shared memory, builds the two (32, 64) feature tiles from them
//    through the index table, masks rows >= N and rows with mask 0, and
//    accumulates a 4 x 4 register tile per thread (plain FP32 FMA).
//  * b = Phi^T (mask * y) is accumulated by the diagonal blocks, each for
//    its own 64 columns, so every column of b is written exactly once.
#include <math.h>

#include "expansion.cuh"

namespace {

constexpr int kT = 64;     // output tile edge
constexpr int kK = 32;     // rows per step
constexpr int kThreads = 256;

template <bool kBank>
__device__ __forceinline__ void
phi_gram_body(const float* __restrict__ X, const float* __restrict__ y,
              const float* __restrict__ mask, int N, int p, int M, int kind,
              int n, const float* __restrict__ consts,
              const float* __restrict__ coef, const int* __restrict__ idx,
              const float* __restrict__ table, const float* __restrict__ d,
              float sig2, int scale, float* __restrict__ out,
              float* __restrict__ b) {
  if (kBank) {
    const size_t slot = blockIdx.y;
    X += slot * N * p;
    y += slot * N;
    mask += slot * N;
    out += slot * M * M;
    b += slot * M;
  }
  // linear block -> (bi, bj) with bi <= bj
  const long long lin = blockIdx.x;
  int bj = (int)((sqrt(8.0 * (double)lin + 1.0) - 1.0) * 0.5);
  while ((long long)bj * (bj + 1) / 2 > lin) --bj;
  while ((long long)(bj + 1) * (bj + 2) / 2 <= lin) ++bj;
  const int bi = (int)(lin - (long long)bj * (bj + 1) / 2);
  const bool diag = (bi == bj);

  extern __shared__ __align__(16) float sh[];
  float* phi_i = sh;                       // [kK][kT]
  float* phi_j = sh + kK * kT;             // [kK][kT]
  float* ys = phi_j + kK * kT;             // [kK]   mask * y
  float* ms = ys + kK;                     // [kK]   mask (0 past N)
  const int col_words = (kind == repro::kHermite) ? p : p + 1;
  float* colinfo = ms + kK;                // [2][col_words][kT]
  float* rows_tab = colinfo + 2 * col_words * kT;
  const int row_words = (kind == repro::kHermite) ? p * n : p;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // column info of the two column ranges, staged once
  for (int e = tid; e < 2 * kT; e += kThreads) {
    const int side = e / kT, c = e % kT;
    const int col = (side == 0 ? bi : bj) * kT + c;
    float* dst = colinfo + side * col_words * kT + c;
    if (kind == repro::kHermite) {
      int* di = reinterpret_cast<int*>(dst);
      for (int j = 0; j < p; ++j) di[j * kT] = (col < M) ? idx[(size_t)col * p + j] : 0;
    } else {
      for (int j = 0; j <= p; ++j) dst[j * kT] = (col < M) ? table[(size_t)j * M + col] : 0.f;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  float bacc = 0.f;

  for (int k0 = 0; k0 < N; k0 += kK) {
    const int rows = min(kK, N - k0);
    __syncthreads();  // previous step fully consumed (and colinfo staged)
    for (int t = tid; t < rows * p; t += kThreads) {
      const int r = t / p, j = t - r * p;
      const float x = X[(size_t)(k0 + r) * p + j];
      if (kind == repro::kHermite) {
        repro::hermite_row(x, consts + 3 * j, coef, n, rows_tab + r * row_words + j * n);
      } else {
        rows_tab[r * row_words + j] = x;
      }
    }
    if (tid < kK) {
      const float mk = (tid < rows) ? mask[k0 + tid] : 0.f;
      ms[tid] = mk;
      ys[tid] = (tid < rows) ? y[k0 + tid] * mk : 0.f;
    }
    __syncthreads();
    const int sides = diag ? 1 : 2;
    for (int e = tid; e < sides * kK * kT; e += kThreads) {
      const int side = e / (kK * kT), rem = e % (kK * kT);
      const int r = rem / kT, c = rem % kT;
      const int col = (side == 0 ? bi : bj) * kT + c;
      float v = 0.f;
      if (r < rows && col < M) {
        const float* tab = rows_tab + r * row_words;
        const float* ci = colinfo + side * col_words * kT + c;
        v = (kind == repro::kHermite)
                ? repro::hermite_feature(tab, reinterpret_cast<const int*>(ci), kT, p, n)
                : repro::rff_feature(tab, ci, kT, p);
        v *= ms[r];
      }
      (side == 0 ? phi_i : phi_j)[r * kT + c] = v;
    }
    __syncthreads();
    const float* pj = diag ? phi_i : phi_j;
#pragma unroll 8
    for (int r = 0; r < kK; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(phi_i + r * kT + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(pj + r * kT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], cv[v], acc[u][v]);
    }
    if (diag && tid < kT) {
      for (int r = 0; r < rows; ++r) bacc = fmaf(ys[r], phi_i[r * kT + tid], bacc);
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = bi * kT + ty * 4 + u;
    if (gi >= M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gj = bj * kT + tx * 4 + v;
      if (gj >= M) continue;
      float val = acc[u][v];
      if (scale) val = val * (d[gi] * d[gj] / sig2) + (gi == gj ? 1.f : 0.f);
      out[(size_t)gi * M + gj] = val;
      if (!diag) out[(size_t)gj * M + gi] = val;
    }
  }
  if (diag && tid < kT && bi * kT + tid < M) b[bi * kT + tid] = bacc;
}

// The two kernels: one body, two launch bounds (see the design notes).
#define PHI_GRAM_PARAMS                                                     \
  const float* __restrict__ X, const float* __restrict__ y,                 \
      const float* __restrict__ mask, int N, int p, int M, int kind, int n, \
      const float* __restrict__ consts, const float* __restrict__ coef,     \
      const int* __restrict__ idx, const float* __restrict__ table,         \
      const float* __restrict__ d, float sig2, int scale,                   \
      float* __restrict__ out, float* __restrict__ b
#define PHI_GRAM_ARGS \
  X, y, mask, N, p, M, kind, n, consts, coef, idx, table, d, sig2, scale, out, b

__global__ void __launch_bounds__(kThreads) phi_gram_kernel(PHI_GRAM_PARAMS) {
  phi_gram_body<false>(PHI_GRAM_ARGS);
}

__global__ void __launch_bounds__(kThreads, 5)
bank_phi_gram_kernel(PHI_GRAM_PARAMS) {
  phi_gram_body<true>(PHI_GRAM_ARGS);
}

#undef PHI_GRAM_ARGS
#undef PHI_GRAM_PARAMS

int launch(const float* X, const float* y, const float* mask, int nbank, int N,
           int p, int M, int kind, int n, const float* consts, const float* coef,
           const int* idx, const float* table, const float* d, float sig2,
           int scale, float* out, float* b, void* stream) {
  const int col_words = (kind == repro::kHermite) ? p : p + 1;
  const int row_words = (kind == repro::kHermite) ? p * n : p;
  const size_t bytes = sizeof(float) * ((size_t)2 * kK * kT + 2 * kK +
                                        (size_t)2 * col_words * kT +
                                        (size_t)kK * row_words);
  const int tiles = (M + kT - 1) / kT;
  const long long blocks = (long long)tiles * (tiles + 1) / 2;
  if (blocks > 2147483647LL || nbank < 1 || nbank > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)nbank);
  auto kernel = (nbank > 1) ? bank_phi_gram_kernel : phi_gram_kernel;
  cudaError_t err = repro::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      X, y, mask, N, p, M, kind, n, consts, coef, idx, table, d, sig2, scale,
      out, b);
  return (int)cudaGetLastError();
}

}  // namespace

// One model: B (scale != 0) or G, and b; X (N, p), y and mask (N,).
extern "C" int repro_phi_gram(const float* X, const float* y, const float* mask,
                              int N, int p, int M, int kind, int n,
                              const float* consts, const float* coef,
                              const int* idx, const float* table, const float* d,
                              float sig2, int scale, float* out, float* b,
                              void* stream) {
  return launch(X, y, mask, 1, N, p, M, kind, n, consts, coef, idx, table, d,
                sig2, scale, out, b, stream);
}

// A bank of nbank models: unscaled G (nbank, M, M) and b (nbank, M);
// X (nbank, N, p), y and mask (nbank, N).
extern "C" int repro_bank_phi_gram(const float* X, const float* y,
                                   const float* mask, int nbank, int N, int p,
                                   int M, int kind, int n, const float* consts,
                                   const float* coef, const int* idx,
                                   const float* table, float* G, float* b,
                                   void* stream) {
  return launch(X, y, mask, nbank, N, p, M, kind, n, consts, coef, idx, table,
                nullptr, 1.f, 0, G, b, stream);
}
