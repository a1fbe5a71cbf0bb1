// Scaled Gram matrix from a materialized feature matrix:
//     B = I + D (Phi^T Phi) D / sigma^2,   D = diag(d),
// Phi (N, M) float32 or bfloat16 (widened on load), accumulated and
// written in float32.
//
// Replaces the TPU kernel repro/kernels/gram.py::scaled_gram_kernel, the
// paper's own formulation: Phi is written out, Phi^T Sigma^-1 Phi comes
// from one product and Lambda^-1 is folded in afterwards.  Here the Gram,
// the sqrt(lambda) scaling, the 1/sigma^2 scaling and the unit diagonal
// are one kernel.
//
// Bound on the H100: float32 operations on the CUDA cores.  The upper
// triangle of the Gram is N*M*(M+1) flops (2.14e12 at N = 10^4,
// M = 14,641: 32 ms at 67 TFLOP/s) against Phi read once and B written
// once (586 MB + 857 MB: 0.43 ms at 3.35 TB/s).  TF32 tensor cores would
// be faster but their 2^-11 input rounding costs up to 9.8e-4 of a sum's
// Cauchy-Schwarz magnitude, above the fit's gates, so this is plain FP32
// FMA.
//
// Design: the fused fit's FMA core (csrc/phi_gram.cu) fed from the stored
// Phi instead of a feature build.
//  * A block owns a 128 x 128 tile of the upper triangle (6,670 blocks at
//    M = 14,641), 256 threads with an 8 x 8 register tile each, laid out
//    as the fused fit's (a warp a 32 x 64 part of the tile, its lanes
//    4 x 8 threads, so each float4 shared load of a row meets 4 or 8
//    distinct addresses), and loops over all N rows itself: no sum crosses
//    blocks.  The tile and its mirror are stored, so B is exactly
//    symmetric; every entry is summed as the fused fit sums it, in strips
//    of 1,024 rows, one fmaf per row from 0.f, the strips added in row
//    order through the block's own output tile (repro::fold_strip), and scaled
//    by repro::scaled_entry, so on the same features B is bitwise the
//    fused fit's.
//  * The two (32, 128) slices of a step come through a three-stage ring
//    in shared memory (96 KB, 2 blocks per SM): step k + 2's slices are
//    loaded while step k's FMAs run, one barrier a step.  A diagonal block
//    loads one side.
//  * Phi's row pitch is odd at the main shape (14,641 floats, 58,564
//    bytes; bfloat16 29,282), so a row starts only 4-byte (2-byte)
//    aligned: 16-byte copies and TMA (16-byte global strides) are ruled
//    out.  Each thread loads its elements one at a time into registers, a
//    quarter step (4 per side) at once, ahead of 8 FMA rows, then widens
//    them into the ring (0 past the ragged edges).  A warp reads 32
//    consecutive columns of one row.  Measured against 4-byte cp.async
//    copies into the ring for float32, this route is as fast and serves
//    both dtypes.
//  * Traffic: Phi (586 MB) is far larger than L2, but the 264 resident
//    blocks read the same 32 rows at about the same time (a 1.9 MB
//    working set), so HBM sees ~25 waves x 586 MB = 14.6 GB: ~4.4 ms at
//    3.35 TB/s, well under the FMA time.  Ragged edges are masked, so Phi
//    is never padded or copied.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 54.2-54.3
// ms at N = 10^4, M = 14,641 float32 with the two-level sum (50.4-50.5
// with one chain; bound 32.0 ms; the former 64 x 64 design 67.4-69.9 ms;
// Phi^T Phi 81 ms); 128 registers, no spill.  With one chain its FMA core
// alone took 40.9 ms and an L2-resident slice was no faster than Phi from
// HBM (benchmarks/torch_phi_gram_ablation.py): the loads' instructions
// and waits, not HBM, took the rest.
#include "expansion.cuh"

namespace {

constexpr int kT = 128;                            // output tile edge
constexpr int kK = 32;                             // rows per step
constexpr int kThreads = 256;
constexpr int kSide = kK * kT;                     // floats of one (32, 128) slice
constexpr int kStages = 3;                         // ring of (32, 128) slice pairs
constexpr int kQuarter = kK / 4;                   // FMA rows between two load batches
constexpr int kPerQuarter = kK * kT / kThreads / 4;  // a thread's loads of a side a quarter
constexpr size_t kSmem = sizeof(float) * kStages * 2 * kSide;
constexpr int kStripSteps = repro::kGramStrip / kK;  // steps a strip
static_assert(repro::kGramStrip % kK == 0, "a strip is whole steps");

// float32 as is; bfloat16 (raw 16 bits, the top half of a float32)
// widened exactly
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// A thread's share of the loads: column `c` of each side, rows
// r, r + 2, ..., r + 30 of a step (r = tid / 128), quarter q holding rows
// 8q + r + 2e, e < 4.  A warp reads 32 consecutive columns of one row.
template <typename T>
struct Loader {
  const T* pi;  // side i, column c of row 0 (Phi itself where c >= M)
  const T* pj;
  bool in_i, in_j, two_sides;
  int r, c;
  size_t pitch2;  // two rows

  // Quarter q of step s into `held` (rows past N and columns past M as 0).
  __device__ __forceinline__ void fetch(int s, int q, int N,
                                        T (&held)[2 * kPerQuarter]) const {
    const int row0 = s * kK + q * kQuarter + r;
    const size_t off = (size_t)row0 * (pitch2 / 2);
#pragma unroll
    for (int e = 0; e < kPerQuarter; ++e) {
      const bool row_ok = row0 + 2 * e < N;
      const size_t o = off + e * pitch2;
      held[e] = (row_ok && in_i) ? pi[o] : T(0);
      if (two_sides) held[kPerQuarter + e] = (row_ok && in_j) ? pj[o] : T(0);
    }
  }

  // The quarter fetched into `held`, widened into the ring stage `dst`.
  __device__ __forceinline__ void deposit(int q, float* dst,
                                          const T (&held)[2 * kPerQuarter]) const {
#pragma unroll
    for (int e = 0; e < kPerQuarter; ++e) {
      const int at = (q * kQuarter + r + 2 * e) * kT + c;
      dst[at] = widen(held[e]);
      if (two_sides) dst[kSide + at] = widen(held[kPerQuarter + e]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
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
  extern __shared__ __align__(16) float ring[];  // [stage][side][kK][kT]

  // a thread's 8 x 8 tile: rows r0 + u and r0 + 16 + u, columns q0 + v and
  // q0 + 32 + v (u, v < 4)
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = (warp / 2) * 32 + (lane / 8) * 4;
  const int q0 = (warp % 2) * 64 + (lane % 8) * 4;
  Loader<T> ld;
  ld.c = tid % kT;
  ld.r = tid / kT;
  const int ci = bi * kT + ld.c, cj = bj * kT + ld.c;
  ld.in_i = ci < M;
  ld.in_j = cj < M;
  ld.two_sides = !diag;
  ld.pi = ld.in_i ? Phi + ci : Phi;
  ld.pj = ld.in_j ? Phi + cj : Phi;
  ld.pitch2 = 2 * (size_t)M;

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  T held[2 * kPerQuarter];
  auto stage = [&](int s) { return ring + (s % kStages) * 2 * kSide; };

  const int steps = (N + kK - 1) / kK;
  // steps 0 .. kStages - 2 ahead of the loop
  for (int s = 0; s < kStages - 1 && s < steps; ++s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ld.fetch(s, q, N, held);
      ld.deposit(q, stage(s), held);
    }
  }
  for (int k = 0; k < steps; ++k) {
    // step k's slices are in the ring for every thread, and step k - 1's
    // reads of the stage that step k + kStages - 1 now fills are retired
    __syncthreads();
    const float* fi = stage(k);
    const float* fj = diag ? fi : fi + kSide;
    const int s = k + kStages - 1;
    float* dst = stage(s);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (s < steps) ld.fetch(s, q, N, held);
#pragma unroll
      for (int r = q * kQuarter; r < (q + 1) * kQuarter; ++r) {
        const float4 a0 = *reinterpret_cast<const float4*>(fi + r * kT + r0);
        const float4 a1 = *reinterpret_cast<const float4*>(fi + r * kT + 16 + r0);
        const float4 c0 = *reinterpret_cast<const float4*>(fj + r * kT + q0);
        const float4 c1 = *reinterpret_cast<const float4*>(fj + r * kT + 32 + q0);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], cv[v], acc[u][v]);
      }
      if (s < steps) ld.deposit(q, dst, held);
    }
    if ((k + 1) % kStripSteps == 0 && k + 1 < steps)
      repro::fold_strip(acc, out, M, bi * kT + r0, bj * kT + q0, k + 1 == kStripSteps);
  }
  if (steps > kStripSteps) repro::join_strips(acc, out, M, bi * kT + r0, bj * kT + q0);
  // the tile and, off the diagonal, its mirror; columns past M dropped
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gi = bi * kT + r0 + (u / 4) * 16 + u % 4;
    if (gi >= M) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gj = bj * kT + q0 + (v / 4) * 32 + v % 4;
      if (gj >= M) continue;
      const float val = repro::scaled_entry(acc[u][v], d[gi], d[gj], sig2, gi == gj);
      out[(size_t)gi * M + gj] = val;
      if (!diag) out[(size_t)gj * M + gi] = val;
    }
  }
}

// The launch for (N, M); errors where it cannot run.
template <typename T>
cudaError_t plan(int N, int M, long long* blocks, int* resident) {
  if (N < 0 || M < 1) return cudaErrorInvalidValue;
  const long long tiles = (M + kT - 1) / kT;
  *blocks = tiles * (tiles + 1) / 2;
  if (*blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaError_t err = repro::allow_smem(scaled_gram_kernel<T>, kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, scaled_gram_kernel<T>,
                                                        kThreads, kSmem);
  if (err != cudaSuccess) return err;
  return *resident < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename T>
int launch(const T* Phi, int N, int M, const float* d, float sig2, float* out,
           void* stream) {
  long long blocks;
  int resident;
  const cudaError_t err = plan<T>(N, M, &blocks, &resident);
  if (err != cudaSuccess) return (int)err;
  scaled_gram_kernel<T><<<(unsigned)blocks, kThreads, kSmem, (cudaStream_t)stream>>>(
      Phi, N, M, d, sig2, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out = {tile edge, rows per step, stages, steps, blocks, shared bytes per
// block, resident blocks per SM, rows a strip} for Phi (N, M), bfloat16 if
// bf16 != 0.
extern "C" int repro_scaled_gram_plan(int N, int M, int bf16, long long* out) {
  long long blocks;
  int resident;
  const cudaError_t err = bf16 ? plan<unsigned short>(N, M, &blocks, &resident)
                               : plan<float>(N, M, &blocks, &resident);
  if (err != cudaSuccess) return (int)err;
  const long long vals[8] = {kT, kK, kStages, (N + kK - 1) / kK, blocks,
                             (long long)kSmem, resident, repro::kGramStrip};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

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
