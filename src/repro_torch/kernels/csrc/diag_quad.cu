// Diagonal of a quadratic form: var_i = a_i^T C a_i = sum_l (A C)_il A_il
// for A (N, M), C (M, M), without the N x N matrix A C A^T.
//
// Replaces the TPU kernel repro/kernels/diag_quad.py::diag_quad_kernel.
//
// Bound on the H100: float32 operations.  One serving microbatch (N = 128,
// M = 14,641) is 2 N M^2 = 5.5e10 flops against one 857 MB read of C, so
// the 67 TFLOP/s float32 rate bounds it (0.82 ms) ahead of the 3.35 TB/s
// read (0.26 ms).
//
// Design: the A C product is computed inside the kernel.  Block (lt, rt)
// owns a 64 x 64 tile T = A[rows] C[:, cols] and streams A and C through
// shared memory in 16-deep slices (a 4 x 4 register tile per thread, plain
// FP32 FMA), then reduces rowsum(T * A[rows, cols]) across its threads to
// one partial per row.  With N = 128 only two row tiles exist, so the
// column axis is what fills the 132 SMs; the per-column-tile partials go to
// a scratch (ceil(M/64), N) buffer the wrapper allocates and a second,
// tiny kernel sums them in a fixed order (deterministic, no atomics).
#include "expansion.cuh"

namespace {

constexpr int kT = 64;
constexpr int kD = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
diag_quad_partial(const float* __restrict__ A, const float* __restrict__ C,
                  int N, int M, float* __restrict__ partial) {
  __shared__ __align__(16) float As[kD][kT];  // As[k][r] = A[r0 + r, k0 + k]
  __shared__ __align__(16) float Cs[kD][kT];  // Cs[k][c] = C[k0 + k, l0 + c]
  const int l0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int k0 = 0; k0 < M; k0 += kD) {
    for (int e = tid; e < kD * kT; e += kThreads) {
      const int r = e / kD, k = e % kD;           // A: consecutive threads along k
      const int gr = r0 + r, gk = k0 + k;
      As[k][r] = (gr < N && gk < M) ? A[(size_t)gr * M + gk] : 0.f;
      const int kc = e / kT, c = e % kT;          // C: consecutive threads along l
      const int gkc = k0 + kc, gl = l0 + c;
      Cs[kc][c] = (gkc < M && gl < M) ? C[(size_t)gkc * M + gl] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kD; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Cs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], cv[v], acc[u][v]);
    }
    __syncthreads();
  }

  // rowsum over this block's 64 columns of T * A; the 16 threads sharing a
  // ty are 16 consecutive lanes of one warp
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int gr = r0 + ty * 4 + u;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gl = l0 + tx * 4 + v;
      if (gr < N && gl < M) s = fmaf(acc[u][v], A[(size_t)gr * M + gl], s);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tx == 0 && gr < N) partial[(size_t)blockIdx.x * N + gr] = s;
  }
}

__global__ void diag_quad_reduce(const float* __restrict__ partial, int N,
                                 int tiles, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * N + i];
  out[i] = s;
}

}  // namespace

extern "C" int repro_diag_quad(const float* A, const float* C, int N, int M,
                               float* partial, float* out, void* stream) {
  const int tiles = (M + kT - 1) / kT;
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(tiles, (N + kT - 1) / kT);
  diag_quad_partial<<<grid, kThreads, 0, s>>>(A, C, N, M, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  diag_quad_reduce<<<(N + 255) / 256, 256, 0, s>>>(partial, N, tiles, out);
  return (int)cudaGetLastError();
}
