// Feature tiles of the kernel expansions, shared by phi_features.cu and
// phi_gram.cu (the counterparts of repro/kernels/hermite_phi.py::phi_tile
// and repro/kernels/rff_phi.py::rff_tile), and the scaled-Gram epilogue
// shared by phi_gram.cu and scaled_gram.cu.
//
// Hermite-Mercer (kind 0): for one input row, the p*n values
//     tab[j*n + d] = psi_d(z_j) * exp(-delta2_j x_j^2),  z_j = rho_j beta_j x_j
// are evaluated once (the gamma-scaled recurrence of
// repro_torch/core/mercer.py::hermite_psi_rows, with the same float32
// constants, read from the (2, n) `coef` table), and feature m of that row
// is the product over j of tab[j*n + idx[m, j]].  The TPU kernel gathers
// with a one-hot matmul on its matrix unit; here the gather is a direct
// shared-memory read through the (M, p) int32 index table.
//
// Random Fourier (kind 1): feature m of row x is cos(sum_j x_j W[j, m] +
// phase[m]) over the (p + 1, M) table [W; phase].
#pragma once

#include <cuda_runtime.h>

namespace repro {

enum TileKind : int { kHermite = 0, kRff = 1 };

// psi_0..psi_{n-1} times the Gaussian envelope for one (row, dimension):
// cj = [beta, delta2, rho*beta]; coef = (2, n) table, row 0 sqrt(2/i),
// row 1 sqrt((i-1)/i).  Writes n values at out[0], out[stride], ...
// The recurrence is pinned (__fmaf_rn, __fmul_rn): every kernel that builds
// these values (phi_features.cu, phi_gram.cu) rounds them alike, whatever
// the compiler would contract in its own context, so the fused fit's Gram
// is bitwise the scaled Gram of the stored features.
__device__ __forceinline__ void hermite_row(float x, const float* cj,
                                            const float* coef, int n,
                                            float* out, int stride) {
  const float beta = cj[0], delta2 = cj[1], zscale = cj[2];
  const float z = zscale * x;
  const float env = expf(-delta2 * x * x);
  float prev = sqrtf(beta);
  out[0] = prev * env;
  if (n > 1) {
    float cur = __fmul_rn(__fmul_rn(z, coef[1]), prev);  // coef[0, 1] = sqrt(2)
    out[stride] = cur * env;
    for (int i = 2; i < n; ++i) {
      const float nxt = __fmaf_rn(__fmul_rn(z, coef[i]), cur,
                                  -__fmul_rn(coef[n + i], prev));
      prev = cur;
      cur = nxt;
      out[i * stride] = cur * env;
    }
  }
}

// Hermite feature from a row table (p*n floats) and the column's p
// multi-index entries (strided by `istride` in shared memory): the left
// fold tab[idx_0] * tab[n + idx_1] * ... (plain products, which no
// compiler contracts, so any kernel that folds in this order agrees).
__device__ __forceinline__ float hermite_feature(const float* tab,
                                                 const int* col_idx,
                                                 int istride, int p, int n) {
  float v = tab[col_idx[0]];
  for (int j = 1; j < p; ++j) v *= tab[j * n + col_idx[j * istride]];
  return v;
}

// RFF feature from a row's p inputs (strided by `xstride`) and the
// column's p+1 table entries (strided by `wstride`); the sum is a pinned
// chain of fused multiply-adds.
__device__ __forceinline__ float rff_feature(const float* x, int xstride,
                                             const float* col_w, int wstride,
                                             int p) {
  float z = 0.f;
  for (int j = 0; j < p; ++j) z = __fmaf_rn(x[j * xstride], col_w[j * wstride], z);
  return cosf(z + col_w[p * wstride]);
}

// One entry of B = I + D G D / sigma^2 from the Gram entry g, pinned so
// that the fused fit (phi_gram.cu) and the scaled Gram (scaled_gram.cu)
// write the same bits for the same G.
__device__ __forceinline__ float scaled_entry(float g, float di, float dj,
                                              float sig2, bool unit) {
  return __fmaf_rn(g, __fdiv_rn(__fmul_rn(di, dj), sig2), unit ? 1.f : 0.f);
}

// Dynamic shared memory above the default 48 KB must be opted into.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
