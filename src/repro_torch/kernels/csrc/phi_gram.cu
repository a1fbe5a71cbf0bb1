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
//    b_s = Phi_s^T (mask_s * y_s) for every slot s in one launch, every
//    slot under the bank's one feature map or (a heterogeneous bank's
//    refit, repro/bank/bank.py::_bank_hetero_refit, which vmaps the fused
//    fit over per-slot hyperparameters) under its own: slot s reads its
//    Hermite constants (p, 3) or its RFF table (p + 1, M) at
//    s * hyper_stride floats (0: the shared map).  A block belongs to one
//    slot, so that is an offset, not another instance;
// with the tile builders hermite_phi.py::phi_tile and rff_phi.py::rff_tile
// inlined.
//
// Bound on the H100: float32 operations on the CUDA cores.  The Gram is
// N*M*(M+1) flops for its upper triangle (2.1e12 at N = 10^4, M = 14,641:
// 32 ms at 67 TFLOP/s) against a few hundred MB of traffic (read X and y
// once, write B once).  For a bank (B slots of N rows, M = 625 at the
// fleet's shape) it is B*N*M*(M+1) flops (2.0e12 at B = 512, N = 10^4), so
// the same rate bounds it.  TF32 tensor cores would be faster but break
// the fit's parity gates.  Every entry is summed by one thread in the
// reference kernel's two levels: strips of 1,024 rows (four of its
// block_k = 256 tiles), one fmaf per row in row order, the strips added in
// row order (repro::fold_strip in expansion.cuh, which says why 1,024), so
// a float32 chain is 1,024 FMAs and ~N/1,024 adds long, not N; the Gram is
// bitwise that of the scaled-Gram kernel on the stored features
// (scaled_gram.cu) and exactly symmetric.
//
// Four costs of regenerating Phi per tile, and what this design does:
//  * Feature work per FMA: a block owns a 128 x 128 tile of the upper
//    triangle (bi <= bj; mirrored on store) and each of its 256 threads an
//    8 x 8 register tile, so a feature built feeds 64 FMAs and four float4
//    shared loads feed 64 FMAs; 6,670 blocks at M = 14,641, 15 a slot at
//    M = 625.
//  * Phases in sequence (row table, feature tiles, FMAs): a two-stage
//    ring instead.  Step k + 1's feature tiles are built from the row
//    table while step k's FMAs read the other stage, and the row table
//    runs one step further ahead, so a step has one barrier and warps in
//    different phases fill each other's gaps.  Every thread both builds
//    (one column of one side) and multiplies.
//  * Feature cost: each column's row-table offsets (j*n + idx[m, j]) are
//    staged once per block, pre-scaled by the table's pitch, and the
//    table is value-major with the 32 rows minor (pitch 33, no bank
//    conflict), so with p unrolled (p <= 8) a Hermite feature is p shared
//    loads at immediate offsets and p - 1 multiplies, then the mask.
//  * The serial tail of diagonal blocks: b = Phi^T (mask * y) is summed
//    by the threads that build the diagonal block's columns, each column
//    once, in row order, while they build, not after the FMAs.
// One block loops over all N rows (the TPU's sequential grid axis), so no
// sum crosses blocks: no atomics, no second pass.  Between strips a
// thread's running totals wait in its block's own output tile (a second
// 8 x 8 register tile would take 64 more registers and halve the blocks
// an SM holds), and b's in b itself.  The slot is the grid's
// y axis; both kernels share one body.  Rows past N are built from x = 0
// and masked, columns past M are built and never stored.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 62.4-62.9
// ms at N = 10^4, M = 14,641 (bound 32.0 ms; Phi^T Phi on a stored Phi,
// 81 ms); the bank 71.9 ms at 512 slots x 10^4 rows, M = 625 (bound 30.0
// ms; bmm 78 ms); 128 registers, the bank entry spilling 8 bytes.  The
// two-level sum costs 5-6% (one-chain sums: 59.4-59.5 and 67.2 ms).
// Before it, the FMA core alone reached 70% of the FP32 rate and the
// feature build added ~12 ms (benchmarks/torch_phi_gram_ablation.py).
#include <math.h>

#include "expansion.cuh"

namespace {

constexpr int kT = 128;          // output tile edge
constexpr int kK = 32;           // rows per step
constexpr int kThreads = 256;
constexpr int kStages = 2;       // feature-tile and row-table ring
constexpr int kPitch = kK + 1;   // row table: value v of row r at v * kPitch + r
constexpr int kMaxP = 8;         // widest input with an unrolled producer
constexpr int kSide = kK * kT;   // floats of one (32, 128) feature tile
constexpr int kMinBlocks = 2;    // resident blocks per SM the kernel is built for
constexpr int kStripSteps = repro::kGramStrip / kK;  // steps a strip
static_assert(repro::kGramStrip % kK == 0, "a strip is whole steps");

// Shared memory in floats: the feature ring [stage][side][kK][kT], mask*y
// and mask [stage][2][kK], the column info [side][col_words][kT] (pitch-
// scaled table offsets for Hermite, [W; phase] for RFF), the row tables
// [stage][row_words][kPitch].
struct Layout {
  int row_words, col_words, feat, ym, col, tab, floats;
};

__host__ __device__ inline Layout layout(int kind, int p, int n) {
  Layout L;
  L.row_words = (kind == repro::kHermite) ? p * n : p;
  L.col_words = (kind == repro::kHermite) ? p : p + 1;
  L.feat = 0;
  L.ym = kStages * 2 * kSide;
  L.col = L.ym + kStages * 2 * kK;
  L.tab = L.col + 2 * L.col_words * kT;
  L.floats = L.tab + kStages * L.row_words * kPitch;
  return L;
}

// Row table and mask of the 32-row step at k0 (rows past N: x = 0, mask 0).
__device__ __forceinline__ void build_rows(const float* __restrict__ X,
                                           const float* __restrict__ y,
                                           const float* __restrict__ mask,
                                           int N, int p, int kind, int n,
                                           const float* __restrict__ consts,
                                           const float* __restrict__ coef,
                                           int k0, float* tab, float* ym) {
  const int tid = threadIdx.x;
  const int rows = min(kK, N - k0);
  for (int t = tid; t < kK * p; t += kThreads) {
    const int j = t / kK, r = t % kK;
    const float x = (r < rows) ? X[(size_t)(k0 + r) * p + j] : 0.f;
    if (kind == repro::kHermite)
      repro::hermite_row(x, consts + 3 * j, coef, n, tab + j * n * kPitch + r, kPitch);
    else
      tab[j * kPitch + r] = x;
  }
  if (tid >= kThreads - kK) {
    const int r = tid - (kThreads - kK);
    const float mk = (r < rows) ? mask[k0 + r] : 0.f;
    ym[r] = (r < rows) ? y[k0 + r] * mk : 0.f;
    ym[kK + r] = mk;
  }
}

// One column of one side for the 32 rows of a step, Hermite, p unrolled:
// the left fold of p table values (at the column's pitch-scaled offsets
// `ci`, strided by kT), times the row's mask.
template <int kP>
__device__ __forceinline__ void hermite_column(const float* __restrict__ tab,
                                               const int* __restrict__ ci,
                                               const float* __restrict__ ms,
                                               float* __restrict__ dst) {
  int off[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) off[j] = ci[j * kT];
#pragma unroll
  for (int r0 = 0; r0 < kK; r0 += 4) {
    const float4 m = *reinterpret_cast<const float4*>(ms + r0);
    const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v = tab[off[0] + r0 + q];
#pragma unroll
      for (int j = 1; j < kP; ++j) v *= tab[off[j] + r0 + q];
      dst[(r0 + q) * kT] = v * mv[q];
    }
  }
}

// The same for any p (p > kMaxP).
__device__ __forceinline__ void hermite_column_any(const float* __restrict__ tab,
                                                   const int* __restrict__ ci, int p,
                                                   const float* __restrict__ ms,
                                                   float* __restrict__ dst) {
#pragma unroll 1
  for (int r = 0; r < kK; ++r) {
    float v = tab[ci[0] + r];
    for (int j = 1; j < p; ++j) v *= tab[ci[j * kT] + r];
    dst[r * kT] = v * ms[r];
  }
}

// One RFF column for the 32 rows of a step (rff_feature of expansion.cuh
// on the row table's inputs, strided by kPitch).
__device__ __forceinline__ void rff_column(const float* __restrict__ tab,
                                           const float* __restrict__ cw, int p,
                                           const float* __restrict__ ms,
                                           float* __restrict__ dst) {
#pragma unroll 1
  for (int r = 0; r < kK; ++r)
    dst[r * kT] = repro::rff_feature(tab + r, kPitch, cw, kT, p) * ms[r];
}

__device__ __forceinline__ void build_column(int kind, int p,
                                             const float* __restrict__ tab,
                                             const float* __restrict__ ci,
                                             const float* __restrict__ ms,
                                             float* __restrict__ dst) {
  if (kind != repro::kHermite) {
    rff_column(tab, ci, p, ms, dst);
    return;
  }
  const int* off = reinterpret_cast<const int*>(ci);
  switch (p) {
    case 1: hermite_column<1>(tab, off, ms, dst); break;
    case 2: hermite_column<2>(tab, off, ms, dst); break;
    case 3: hermite_column<3>(tab, off, ms, dst); break;
    case 4: hermite_column<4>(tab, off, ms, dst); break;
    case 5: hermite_column<5>(tab, off, ms, dst); break;
    case 6: hermite_column<6>(tab, off, ms, dst); break;
    case 7: hermite_column<7>(tab, off, ms, dst); break;
    case 8: hermite_column<kMaxP>(tab, off, ms, dst); break;
    default: hermite_column_any(tab, off, p, ms, dst);
  }
}

template <bool kBank>
__device__ __forceinline__ void
phi_gram_body(const float* __restrict__ X, const float* __restrict__ y,
              const float* __restrict__ mask, int N, int p, int M, int kind,
              int n, const float* __restrict__ consts,
              const float* __restrict__ coef, const int* __restrict__ idx,
              const float* __restrict__ table, const float* __restrict__ d,
              float sig2, int scale, float* __restrict__ out,
              float* __restrict__ b, long long hyper_stride) {
  if (kBank) {
    const size_t slot = blockIdx.y;
    X += slot * N * p;
    y += slot * N;
    mask += slot * N;
    out += slot * M * M;
    b += slot * M;
    if (kind == repro::kHermite)
      consts += slot * hyper_stride;
    else
      table += slot * hyper_stride;
  }
  // linear block -> (bi, bj) with bi <= bj
  const long long lin = blockIdx.x;
  int bj = (int)((sqrt(8.0 * (double)lin + 1.0) - 1.0) * 0.5);
  while ((long long)bj * (bj + 1) / 2 > lin) --bj;
  while ((long long)(bj + 1) * (bj + 2) / 2 <= lin) ++bj;
  const int bi = (int)(lin - (long long)bj * (bj + 1) / 2);
  const bool diag = (bi == bj);

  extern __shared__ __align__(16) float sh[];
  const Layout L = layout(kind, p, n);
  const int tid = threadIdx.x;
  // FMA role: a warp owns a 32 x 64 part of the tile, its lanes 4 x 8
  // threads; a thread rows r0 + u and r0 + 16 + u, columns q0 + v and
  // q0 + 32 + v (u, v < 4), so each float4 shared load of a row meets 4
  // or 8 distinct addresses, one wavefront
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = (warp / 2) * 32 + (lane / 8) * 4;
  const int q0 = (warp % 2) * 64 + (lane % 8) * 4;
  // build role: column c of side `side` (a diagonal block has one side,
  // built by threads 0-127, which also sum b)
  const int side = tid / kT, c = tid % kT;
  const bool builds = !diag || side == 0;
  const int col = (side == 0 ? bi : bj) * kT + c;
  float* const colinfo = sh + L.col + side * L.col_words * kT + c;

  if (kind == repro::kHermite) {
    int* ci = reinterpret_cast<int*>(colinfo);
    for (int j = 0; j < p; ++j)
      ci[j * kT] = (j * n + (col < M ? idx[(size_t)col * p + j] : 0)) * kPitch;
  } else {
    for (int j = 0; j <= p; ++j) colinfo[j * kT] = (col < M) ? table[(size_t)j * M + col] : 0.f;
  }

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;
  float bacc = 0.f;  // b's strip; its running total waits in b[col]

  const int steps = (N + kK - 1) / kK;
  auto tab_of = [&](int s) { return sh + L.tab + s * L.row_words * kPitch; };
  auto ym_of = [&](int s) { return sh + L.ym + s * 2 * kK; };
  auto feat_of = [&](int s) { return sh + L.feat + s * 2 * kSide; };
  // step s's feature column from its row table, and on a diagonal block
  // its part of b, row by row
  auto build = [&](int s) {
    if (!builds) return;
    const int st = s % kStages;
    const float* ym = ym_of(st);
    float* dst = feat_of(st) + side * kSide + c;
    build_column(kind, p, tab_of(st), colinfo, ym + kK, dst);
    if (diag) {
#pragma unroll 8
      for (int r = 0; r < kK; ++r) bacc = fmaf(ym[r], dst[r * kT], bacc);
      if ((s + 1) % kStripSteps == 0 && s + 1 < steps) {
        if (col < M) b[col] = (s + 1 == kStripSteps) ? bacc : __fadd_rn(b[col], bacc);
        bacc = 0.f;
      }
    }
  };

  // step k's FMAs read one stage while step k + 1's features are built
  // into the other from their row table, and step k + 2's rows go into
  // the table stage step k's rows held (consumed before the last barrier);
  // k = -1 only builds ahead
  if (steps > 0) build_rows(X, y, mask, N, p, kind, n, consts, coef, 0, tab_of(0), ym_of(0));
  __syncthreads();
  for (int k = -1; k < steps; ++k) {
    if (k + 1 < steps) build(k + 1);
    if (k + 2 < steps)
      build_rows(X, y, mask, N, p, kind, n, consts, coef, (k + 2) * kK,
                 tab_of((k + 2) % kStages), ym_of((k + 2) % kStages));
    if (k >= 0) {
      const float* fi = feat_of(k % kStages);
      const float* fj = diag ? fi : fi + kSide;
#pragma unroll
      for (int r = 0; r < kK; ++r) {
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
      if ((k + 1) % kStripSteps == 0 && k + 1 < steps)
        repro::fold_strip(acc, out, M, bi * kT + r0, bj * kT + q0,
                          k + 1 == kStripSteps);
    }
    __syncthreads();  // step k consumed; step k + 1's features built
  }
  if (steps > kStripSteps) repro::join_strips(acc, out, M, bi * kT + r0, bj * kT + q0);

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gi = bi * kT + r0 + (u / 4) * 16 + u % 4;
    if (gi >= M) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gj = bj * kT + q0 + (v / 4) * 32 + v % 4;
      if (gj >= M) continue;
      float val = acc[u][v];
      if (scale) val = repro::scaled_entry(val, d[gi], d[gj], sig2, gi == gj);
      out[(size_t)gi * M + gj] = val;
      if (!diag) out[(size_t)gj * M + gi] = val;
    }
  }
  if (diag && side == 0 && col < M)
    b[col] = (steps > kStripSteps) ? __fadd_rn(b[col], bacc) : bacc;
}

// The two kernels: one body, the bank's slot offsets compiled in or out.
#define PHI_GRAM_PARAMS                                                     \
  const float* __restrict__ X, const float* __restrict__ y,                 \
      const float* __restrict__ mask, int N, int p, int M, int kind, int n, \
      const float* __restrict__ consts, const float* __restrict__ coef,     \
      const int* __restrict__ idx, const float* __restrict__ table,         \
      const float* __restrict__ d, float sig2, int scale,                   \
      float* __restrict__ out, float* __restrict__ b, long long hyper_stride
#define PHI_GRAM_ARGS                                                        \
  X, y, mask, N, p, M, kind, n, consts, coef, idx, table, d, sig2, scale, out, b, \
      hyper_stride

__global__ void __launch_bounds__(kThreads, kMinBlocks)
phi_gram_kernel(PHI_GRAM_PARAMS) {
  phi_gram_body<false>(PHI_GRAM_ARGS);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bank_phi_gram_kernel(PHI_GRAM_PARAMS) {
  phi_gram_body<true>(PHI_GRAM_ARGS);
}

#undef PHI_GRAM_ARGS
#undef PHI_GRAM_PARAMS

struct GramPlan {
  long long tiles, blocks_per_slot, blocks, smem;
  int resident;  // blocks per SM at this shared-memory size
};

// The launch for (N, M, nbank, kind, p, n); errors where it cannot run.
cudaError_t gram_plan(int N, int M, int nbank, int kind, int p, int n,
                      GramPlan* plan) {
  if (N < 0 || M < 1 || p < 1 || n < 1 || nbank < 1 || nbank > 65535 ||
      (kind != repro::kHermite && kind != repro::kRff))
    return cudaErrorInvalidValue;
  GramPlan P;
  P.tiles = (M + kT - 1) / kT;
  P.blocks_per_slot = P.tiles * (P.tiles + 1) / 2;
  if (P.blocks_per_slot > 2147483647LL) return cudaErrorInvalidConfiguration;
  P.blocks = P.blocks_per_slot * nbank;
  P.smem = (long long)sizeof(float) * layout(kind, p, n).floats;
  auto kernel = (nbank > 1) ? bank_phi_gram_kernel : phi_gram_kernel;
  cudaError_t err = repro::allow_smem(kernel, (size_t)P.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&P.resident, kernel, kThreads,
                                                        (size_t)P.smem);
  if (err != cudaSuccess) return err;
  if (P.resident < 1) return cudaErrorInvalidConfiguration;
  *plan = P;
  return cudaSuccess;
}

int launch(const float* X, const float* y, const float* mask, int nbank, int N,
           int p, int M, int kind, int n, const float* consts, const float* coef,
           const int* idx, const float* table, const float* d, float sig2,
           int scale, float* out, float* b, long long hyper_stride, void* stream) {
  GramPlan P;
  const cudaError_t err = gram_plan(N, M, nbank, kind, p, n, &P);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)P.blocks_per_slot, (unsigned)nbank);
  auto kernel = (nbank > 1) ? bank_phi_gram_kernel : phi_gram_kernel;
  kernel<<<grid, kThreads, (size_t)P.smem, (cudaStream_t)stream>>>(
      X, y, mask, N, p, M, kind, n, consts, coef, idx, table, d, sig2, scale,
      out, b, hyper_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// out = {tile edge, rows per step, stages, steps, tile rows, blocks per
// slot, blocks, shared bytes per block, resident blocks per SM, rows a
// strip}.
extern "C" int repro_phi_gram_plan(int N, int M, int nbank, int kind, int p, int n,
                                   long long* out) {
  GramPlan P;
  const cudaError_t err = gram_plan(N, M, nbank, kind, p, n, &P);
  if (err != cudaSuccess) return (int)err;
  const long long vals[10] = {kT, kK, kStages, (N + kK - 1) / kK, P.tiles,
                              P.blocks_per_slot, P.blocks, P.smem, P.resident,
                              repro::kGramStrip};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

// One model: B (scale != 0) or G, and b; X (N, p), y and mask (N,).
extern "C" int repro_phi_gram(const float* X, const float* y, const float* mask,
                              int N, int p, int M, int kind, int n,
                              const float* consts, const float* coef,
                              const int* idx, const float* table, const float* d,
                              float sig2, int scale, float* out, float* b,
                              void* stream) {
  return launch(X, y, mask, 1, N, p, M, kind, n, consts, coef, idx, table, d,
                sig2, scale, out, b, 0, stream);
}

// A bank of nbank models: unscaled G (nbank, M, M) and b (nbank, M);
// X (nbank, N, p), y and mask (nbank, N); slot s's Hermite constants or RFF
// table at s * hyper_stride floats (0: one map for every slot).
extern "C" int repro_bank_phi_gram(const float* X, const float* y,
                                   const float* mask, int nbank, int N, int p,
                                   int M, int kind, int n, const float* consts,
                                   const float* coef, const int* idx,
                                   const float* table, float* G, float* b,
                                   void* stream, long long hyper_stride) {
  if (hyper_stride < 0) return (int)cudaErrorInvalidValue;
  return launch(X, y, mask, nbank, N, p, M, kind, n, consts, coef, idx, table,
                nullptr, 1.f, 0, G, b, hyper_stride, stream);
}
