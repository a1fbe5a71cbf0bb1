// Expansion features Phi(X): (N, p) rows -> (N, M), written once.
//
// Replaces the TPU kernel repro/kernels/hermite_phi.py::hermite_phi_kernel
// (generic over the tile builder, so it serves the Hermite-Mercer and the
// random-Fourier expansions alike).
//
// Bound on the H100: the (N, M) float32 write.  At the serving shape (128
// query rows, M = 14,641) that is 7.5 MB, a few microseconds at 3.35 TB/s,
// so in practice the launch itself dominates.  The design keeps the write
// coalesced (one thread per feature column, consecutive threads on
// consecutive columns of the same row) and evaluates the per-row,
// per-dimension Hermite values once per block into shared memory (p*n
// floats a row), so each output element costs p shared-memory reads and
// p - 1 multiplies.  No padding: the ragged row and column edges are
// masked here, and no padded RFF column is ever written.
#include "expansion.cuh"

namespace {

constexpr int kCols = 128;  // threads per block, one feature column each

__global__ void phi_features_kernel(const float* __restrict__ X, int N, int p,
                                    int M, int kind, int n, int rows_per_block,
                                    const float* __restrict__ consts,
                                    const float* __restrict__ coef,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ table,
                                    float* __restrict__ out) {
  extern __shared__ __align__(16) float sh[];
  // layout: column info (p ints or p + 1 floats per column), then the row
  // tables (p*n floats per row for Hermite, the p inputs for RFF)
  const int col_words = (kind == repro::kHermite) ? p : p + 1;
  int* sidx = reinterpret_cast<int*>(sh);
  float* sw = sh;
  float* rows_tab = sh + col_words * kCols;
  const int row_words = (kind == repro::kHermite) ? p * n : p;

  const int m = blockIdx.x * kCols + threadIdx.x;
  if (m < M) {
    if (kind == repro::kHermite) {
      for (int j = 0; j < p; ++j) sidx[j * kCols + threadIdx.x] = idx[(size_t)m * p + j];
    } else {
      for (int j = 0; j <= p; ++j) sw[j * kCols + threadIdx.x] = table[(size_t)j * M + m];
    }
  }

  for (int r0 = blockIdx.y * rows_per_block; r0 < N; r0 += gridDim.y * rows_per_block) {
    const int rows = min(rows_per_block, N - r0);
    __syncthreads();  // previous row tile fully consumed
    for (int t = threadIdx.x; t < rows * p; t += blockDim.x) {
      const int r = t / p, j = t - r * p;
      const float x = X[(size_t)(r0 + r) * p + j];
      if (kind == repro::kHermite) {
        repro::hermite_row(x, consts + 3 * j, coef, n, rows_tab + r * row_words + j * n, 1);
      } else {
        rows_tab[r * row_words + j] = x;
      }
    }
    __syncthreads();
    if (m < M) {
      for (int r = 0; r < rows; ++r) {
        const float* tab = rows_tab + r * row_words;
        const float v = (kind == repro::kHermite)
            ? repro::hermite_feature(tab, sidx + threadIdx.x, kCols, p, n)
            : repro::rff_feature(tab, 1, sw + threadIdx.x, kCols, p);
        out[(size_t)(r0 + r) * M + m] = v;
      }
    }
  }
}

}  // namespace

extern "C" int repro_phi_features(const float* X, int N, int p, int M, int kind,
                                  int n, const float* consts, const float* coef,
                                  const int* idx, const float* table, float* out,
                                  void* stream) {
  const int col_words = (kind == repro::kHermite) ? p : p + 1;
  const int row_words = (kind == repro::kHermite) ? p * n : p;
  int rows = 16;
  size_t bytes = 0;
  for (;; rows /= 2) {
    bytes = sizeof(float) * ((size_t)col_words * kCols + (size_t)rows * row_words);
    if (bytes <= 48 * 1024 || rows == 1) break;
  }
  cudaError_t err = repro::allow_smem(phi_features_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (N + rows - 1) / rows;
  dim3 grid((M + kCols - 1) / kCols, row_tiles < 65535 ? row_tiles : 65535);
  phi_features_kernel<<<grid, kCols, bytes, (cudaStream_t)stream>>>(
      X, N, p, M, kind, n, rows, consts, coef, idx, table, out);
  return (int)cudaGetLastError();
}
