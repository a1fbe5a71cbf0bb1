// Feature tiles of the kernel expansions, shared by phi_features.cu and
// phi_gram.cu (the counterparts of repro/kernels/hermite_phi.py::phi_tile
// and repro/kernels/rff_phi.py::rff_tile), and the scaled-Gram epilogue
// and two-level row sum shared by phi_gram.cu and scaled_gram.cu.
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

// The Gram's two-level row sum, the reference kernel's structure
// (repro/kernels/phi_gram.py contracts a block_k = 256-row tile per grid
// step and adds the tiles in order; the scaled Gram takes the same strips
// so that it stays bitwise the fused fit's): each entry sums a strip of
// kGramStrip rows in registers from 0.f, one fmaf a row, and the strips
// join a running total in row order.  A block's 8 x 8 register tiles are
// at rows i0 + (u / 4) * 16 + u % 4 and columns j0 + (v / 4) * 32 + v % 4
// of its own output tile, and the total is kept there, in the output
// itself: no other block touches that tile before the end (a mirror is
// written only below the diagonal), so it needs no scratch and no
// atomics.  A fold is 64 loads and 64 stores a thread (64 KB a block each
// way), and across the grid it costs too much to fold every 256 rows: the
// strips are 1,024 rows, four of the reference's tiles, 9 folds at
// N = 10^4 where 256-row strips take 39 (benchmarks/
// torch_phi_gram_ablation.py times the fused fit at 256 and 512 rows
// beside this one; PERF.md row 1).  A float32 chain is then 1,024 FMAs
// and ~N/1,024 adds long instead of N.
constexpr int kGramStrip = 1024;

// The fold's operands pass through an empty asm statement, so the
// compiler cannot compute its 64 addresses and bounds once, outside the
// row loop: held there across the FMAs they would push the 8 x 8 tile
// (the kernels run at their 128-register cap) into local memory.
__device__ __forceinline__ void opaque(float*& out, int& M, int& i0, int& j0) {
  unsigned long long p = reinterpret_cast<unsigned long long>(out);
  asm volatile("" : "+l"(p), "+r"(M), "+r"(i0), "+r"(j0));
  out = reinterpret_cast<float*>(p);
}

// A strip's sums into the running total (the first strip is the total),
// then zeroed for the next strip; entries past M only zeroed.  Two rows'
// 16 loads go out together ahead of their stores (a load cannot pass an
// earlier store the compiler cannot tell apart from it).
__device__ __forceinline__ void fold_strip(float (&acc)[8][8], float* out,
                                           int M, int i0, int j0, bool first) {
  opaque(out, M, i0, j0);
#pragma unroll
  for (int u0 = 0; u0 < 8; u0 += 2) {
    float held[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = i0 + ((u0 + h) / 4) * 16 + (u0 + h) % 4;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int gj = j0 + (v / 4) * 32 + v % 4;
        held[h][v] = (first || gi >= M || gj >= M) ? 0.f : out[(size_t)gi * M + gj];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + h;
      const int gi = i0 + (u / 4) * 16 + u % 4;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int gj = j0 + (v / 4) * 32 + v % 4;
        if (gi < M && gj < M)
          out[(size_t)gi * M + gj] = first ? acc[u][v] : __fadd_rn(held[h][v], acc[u][v]);
        acc[u][v] = 0.f;
      }
    }
  }
}

// The last strip joins the total: acc becomes the whole sum.
__device__ __forceinline__ void join_strips(float (&acc)[8][8], const float* out,
                                            int M, int i0, int j0) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gi = i0 + (u / 4) * 16 + u % 4;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gj = j0 + (v / 4) * 32 + v % 4;
      if (gi < M && gj < M) acc[u][v] = __fadd_rn(out[(size_t)gi * M + gj], acc[u][v]);
    }
  }
}

// Dynamic shared memory above the default 48 KB must be opted into.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
