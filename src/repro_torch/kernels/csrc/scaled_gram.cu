// Scaled Gram matrix from a materialized feature matrix:
//     B = I + D (Phi^T Phi) D / sigma^2,   D = diag(d),
// Phi (N, M) float32 or bfloat16 (widened on load), accumulated and
// written in float32.
//
// Replaces the TPU kernel repro/kernels/gram.py::scaled_gram_kernel, the
// paper's own formulation: Phi is written out, Phi^T Sigma^-1 Phi comes
// from one product and Lambda^-1 is folded in afterwards.  Here the Gram,
// the sqrt(lambda) scaling, the 1/sigma^2 scaling and the unit diagonal
// are one kernel: Phi is read, B written once.
//
// Bound on the H100: float32 operations on the CUDA cores.  The upper
// triangle of the Gram is N*M*(M+1) flops (2.14e12 at N = 10^4,
// M = 14,641: 32 ms at 67 TFLOP/s) against Phi read once and B written
// once (586 MB + 857 MB: 0.43 ms at 3.35 TB/s).  TF32 tensor cores would
// be faster but their 2^-11 input rounding costs up to 9.8e-4 of a sum's
// Cauchy-Schwarz magnitude, above the fit's gates, so this is plain FP32
// FMA.
//
// Design:
//  * One block owns one 64 x 64 tile of the upper triangle (bi <= bj) and
//    loops over all N rows itself: no sum crosses blocks, no atomics, no
//    second pass.  The loop takes the place of the TPU's sequential grid
//    axis over N.
//  * Per 32-row step the block stages the (32, 64) slices of Phi under
//    both of its column ranges in shared memory (one on the diagonal).  A
//    warp reads 32 consecutive columns of one row, so the loads coalesce.
//  * Each thread accumulates a 4 x 4 register tile.
//  * The epilogue multiplies by d_i d_j / sigma^2 and adds the unit
//    diagonal (repro::scaled_entry, shared with the fused fit), then
//    stores the tile and, off the diagonal, its mirror: B comes out
//    exactly symmetric for the Cholesky.  Each entry is summed in row
//    order, one fmaf per row, as in csrc/phi_gram.cu, so on the same
//    features the two kernels write the same bits.
//  * Ragged edges are masked (columns >= M, rows >= N), so no padded copy
//    of Phi is made (the JAX wrapper pads; at the main shape that would be
//    586 MB).
#include "expansion.cuh"

namespace {

constexpr int kT = 64;     // output tile edge
constexpr int kK = 32;     // rows per step
constexpr int kThreads = 256;

// float32 as is; bfloat16 (raw 16 bits, the top half of a float32) widened
// exactly by a shift
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_gram_kernel(const T* __restrict__ Phi, int N, int M,
                   const float* __restrict__ d, float sig2,
                   float* __restrict__ out) {
  // linear block -> (bi, bj) with bi <= bj
  const long long lin = blockIdx.x;
  int bj = (int)((sqrt(8.0 * (double)lin + 1.0) - 1.0) * 0.5);
  while ((long long)bj * (bj + 1) / 2 > lin) --bj;
  while ((long long)(bj + 1) * (bj + 2) / 2 <= lin) ++bj;
  const int bi = (int)(lin - (long long)bj * (bj + 1) / 2);
  const bool diag = (bi == bj);

  __shared__ __align__(16) float phi_i[kK * kT];
  __shared__ __align__(16) float phi_j[kK * kT];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // loader: column lc of rows lr, lr + 4, ..., lr + 28 of the step
  const int lc = tid % kT, lr = tid / kT;
  const int ci = bi * kT + lc, cj = bj * kT + lc;
  const bool in_i = ci < M, in_j = cj < M;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kK) {
    const int rows = min(kK, N - k0);
    __syncthreads();  // previous step fully consumed
#pragma unroll
    for (int s = 0; s < kK / 4; ++s) {
      const int r = lr + 4 * s;
      const T* row = Phi + (size_t)(k0 + r) * M;
      phi_i[r * kT + lc] = (r < rows && in_i) ? widen(row[ci]) : 0.f;
      if (!diag) phi_j[r * kT + lc] = (r < rows && in_j) ? widen(row[cj]) : 0.f;
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
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gi = bi * kT + ty * 4 + u;
    if (gi >= M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gj = bj * kT + tx * 4 + v;
      if (gj >= M) continue;
      const float val = repro::scaled_entry(acc[u][v], d[gi], d[gj], sig2, gi == gj);
      out[(size_t)gi * M + gj] = val;
      if (!diag) out[(size_t)gj * M + gi] = val;
    }
  }
}

template <typename T>
int launch(const T* Phi, int N, int M, const float* d, float sig2, float* out,
           void* stream) {
  if (N < 0 || M < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = (M + kT - 1) / kT;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  scaled_gram_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      Phi, N, M, d, sig2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// B (M, M) from Phi (N, M) float32, d (M,), sigma^2.
extern "C" int repro_scaled_gram_f32(const float* Phi, int N, int M, const float* d,
                                     float sig2, float* out, void* stream) {
  return launch(Phi, N, M, d, sig2, out, stream);
}

// The same from a bfloat16 Phi, widened to float32 on load.
extern "C" int repro_scaled_gram_bf16(const void* Phi, int N, int M, const float* d,
                                      float sig2, float* out, void* stream) {
  return launch(static_cast<const unsigned short*>(Phi), N, M, d, sig2, out, stream);
}
