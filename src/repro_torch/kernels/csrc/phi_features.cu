// Expansion features Phi(X): (N, p) rows -> (N, M), written once.
//
// Replaces the TPU kernel repro/kernels/hermite_phi.py::hermite_phi_kernel
// (generic over the tile builder, so it serves the Hermite-Mercer and the
// random-Fourier expansions alike).
//
// Bound on the H100: the (N, M) float32 write.  586 MB at N = 10^4,
// M = 14,641 (phase 6's stored Phi, 0.175 ms at 3.35 TB/s); 7.5 MB for a
// 128-row serving microbatch, where the launch itself costs more.
//
// What the design does about it:
//  * Work per thread and per block.  128 threads; thread t of block bx
//    owns C columns m = bx * 128 C + c * 128 + t, c < C (a warp's store is
//    128 contiguous bytes), and holds their p pitch-scaled row-table
//    offsets (Hermite) or p + 1 [W; phase] entries (RFF) in registers for
//    the whole launch.  C (1 or 8) is a template parameter, so no column
//    slot is predicated off.  A block walks a strip of 32-row tiles.  The
//    launch plan (repro_phi_features_plan) takes C = 8 where that grid
//    still fills the card once (resident blocks x SMs), else C = 1, and
//    cuts the strips so the grid is at most that one wave: at N = 10^4,
//    M = 14,641, 15 x 35 blocks of 8 columns a thread, each writing 9 tiles
//    of 128 KB; at the serving shapes one column a thread, for parallelism.
//    Two and four columns a thread were slower than eight at the one path
//    shape that fills the card with them, so they have no instance.
//  * Row tables off the critical path.  Two shared buffers: tile t is
//    stored from one while the next tile's rows (32 rows x p inputs, spread
//    over the four warps alike) are built into the other, one barrier a
//    tile.  The next tile's inputs are loaded before the stores are issued,
//    so their latency hides behind them.
//  * Stores.  A thread's C x 32 stores of a tile are independent; each
//    element is p shared loads at immediate offsets (the table is
//    value-major, the tile's rows minor at pitch 33: no bank conflict) and
//    p - 1 multiplies.  Plain coalesced 4-byte stores: M = 14,641 gives an
//    odd row pitch, so no row is 16-byte aligned.  Wider blocks write
//    longer runs of each row, which the card writes faster.
//  * Small shapes.  The plan is host arithmetic on a per-device cache (the
//    SM count and each instance's residency are asked of the runtime once),
//    so a launch is one kernel and no synchronization.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUDA-graph replays,
// benchmarks/torch_phi_gram_ablation.py): 0.27 ms at 10^4 x 14,641
// (65% of the write bound; out.fill_ writes the same bytes in 0.179 ms with
// aligned 16-byte stores), 4.9 us for a 128-row serving microbatch, 4.2 us
// for a fleet microbatch of 256 x 625.
//
// Per-row constants (a heterogeneous bank's serving and its update and
// downdate groups, repro/bank/bank.py::_hetero_gathered_mean_var and
// _hetero_group_features, which vmap the feature map over per-row
// hyperparameters): with `row_slot` (N,) int32, row r's Hermite values are
// built from the (p, 3) constants at consts + 3 p row_slot[r] of a (C, p, 3)
// table; null is the shared (p, 3).  The row table is built row by row, so
// that is an address, not another instance.  The RFF instances keep each
// column's [W; phase] in registers across rows, so they take no per-row
// table: a caller scales the rows instead.
//
// Bits: every element is the pinned recurrence repro::hermite_row folded
// left in order j = 0..p-1 with plain products, or the __fmaf_rn chain and
// cosf of repro::rff_feature (expansion.cuh), as the fused fit
// (phi_gram.cu) builds it, so the scaled Gram of this Phi is bitwise the
// fused fit's B.  p <= 8 has instances with p unrolled; a wider input
// keeps its column data in shared memory.
#include <mutex>

#include "expansion.cuh"

namespace {

constexpr int kThreads = 128;       // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kWide = 8;            // columns a thread of the wide instances (else 1)
constexpr int kRows = 32;           // rows per tile
constexpr int kPitch = kRows + 1;   // row table: value v of row r at v * kPitch + r
constexpr int kMaxP = 8;            // widest input with an unrolled instance
// resident blocks per SM an instance is built for: 64 registers a thread
// while the columns' data takes at most 20 of them (past p = 4 only at one
// column a thread: two would spill), else 128
constexpr int min_blocks(int p, int c) { return c * (p + 1) <= 20 && (p <= 4 || c == 1) ? 8 : 4; }
constexpr int kInstances = 2 * (kMaxP + 1) * 2;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void put(float* dst, float v) { *dst = v; }

// The build tasks of a tile, (input j, row r) for t = j * kRows + r, go to
// the threads lane-major so each warp takes an equal share.
__device__ __forceinline__ int first_task() {
  return (threadIdx.x % 32) * kWarps + threadIdx.x / 32;
}

// One build task: the n Hermite values of x (down the table at pitch
// kPitch) or x itself (RFF).
template <int kKind>
__device__ __forceinline__ void build_task(float x, int j, int r, int n,
                                           const float* __restrict__ consts,
                                           const float* __restrict__ coef,
                                           float* tab) {
  if (kKind == repro::kHermite)
    repro::hermite_row(x, consts + 3 * j, coef, n, tab + j * n * kPitch + r, kPitch);
  else
    tab[j * kPitch + r] = x;
}

// Hermite, p unrolled: the tile's rows from the table at the thread's
// offsets, stored down the rows from dst (row 0 of the tile, column m0).
template <int kP, int kC>
__device__ __forceinline__ void store_hermite(const float* __restrict__ tab,
                                              const int (&off)[kC][kP],
                                              const bool (&ok)[kC],
                                              float* __restrict__ dst, int M,
                                              int rows) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (ok[c]) {
          float v = tab[off[c][0] + r];
#pragma unroll
          for (int j = 1; j < kP; ++j) v *= tab[off[c][j] + r];
          put(dst + c * kThreads, v);
        }
      }
      dst += M;
    }
  }
}

// RFF, p unrolled; four rows at a time, so four cosf chains are in flight.
template <int kP, int kC>
__device__ __forceinline__ void store_rff(const float* __restrict__ tab,
                                          const float (&w)[kC][kP + 1],
                                          const bool (&ok)[kC],
                                          float* __restrict__ dst, int M,
                                          int rows) {
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float x[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) x[j] = tab[j * kPitch + r];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (ok[c]) {
        float z = 0.f;
#pragma unroll
        for (int j = 0; j < kP; ++j) z = __fmaf_rn(x[j], w[c][j], z);
        put(dst + c * kThreads, cosf(z + w[c][kP]));
      }
    }
    dst += M;
  }
}

// Any p: the column data in shared memory, `col` the thread's first column
// there, columns `width` apart per input.
template <int kKind, int kC>
__device__ __forceinline__ void store_any(const float* __restrict__ tab,
                                          const float* __restrict__ col, int p,
                                          const bool (&ok)[kC],
                                          float* __restrict__ dst, int M,
                                          int rows) {
  constexpr int width = kC * kThreads;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (ok[c]) {
        const float* cc = col + c * kThreads;
        float v;
        if (kKind == repro::kHermite) {
          const int* o = reinterpret_cast<const int*>(cc);
          v = tab[o[0] + r];
          for (int j = 1; j < p; ++j) v *= tab[o[j * width] + r];
        } else {
          v = repro::rff_feature(tab + r, kPitch, cc, width, p);
        }
        put(dst + c * kThreads, v);
      }
    }
    dst += M;
  }
}

// kP = 0: any p.  kC columns a thread, kC * kThreads a block.  Shared
// memory: the two row tables [2][p*n or p][kPitch], then (kP = 0 only) the
// column data [p or p + 1][kC * kThreads].
template <int kKind, int kP, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks(kP, kC))
phi_features_kernel(const float* __restrict__ X, int N, int p, int M, int n,
                    int tiles_per_block,
                    const float* __restrict__ consts,
                    const float* __restrict__ coef,
                    const int* __restrict__ idx,
                    const float* __restrict__ table,
                    const int* __restrict__ row_slot,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float sh[];
  constexpr bool kHermite = kKind == repro::kHermite;
  constexpr int kPr = kP > 0 ? kP : 1;
  // build tasks a thread takes per tile with p unrolled (any p: a loop)
  constexpr int kTasks = (kRows * kPr + kThreads - 1) / kThreads;
  const int row_words = kHermite ? p * n : p;
  const int tab_floats = row_words * kPitch;
  constexpr int width = kC * kThreads;
  const int m0 = blockIdx.x * width + threadIdx.x;
  bool ok[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) ok[c] = m0 + c * kThreads < M;

  // the block's strip: count tiles from t_first
  const int tiles = (N + kRows - 1) / kRows;
  const int t_first = blockIdx.y * tiles_per_block;
  const int count = min(tiles_per_block, tiles - t_first);
  if (count <= 0) return;

  // the columns' data, once: registers (p unrolled) or shared memory
  int off[kC][kPr];
  float w[kC][kPr + 1];
  float* col = sh + 2 * tab_floats + threadIdx.x;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int m = ok[c] ? m0 + c * kThreads : 0;
    if (kP > 0) {
#pragma unroll
      for (int j = 0; j < kPr; ++j) {
        if (kHermite) {
          off[c][j] = (j * n + idx[(size_t)m * kPr + j]) * kPitch;
        } else {
          w[c][j] = table[(size_t)j * M + m];
        }
      }
      if (!kHermite) w[c][kPr] = table[(size_t)kPr * M + m];
    } else if (ok[c]) {
      if (kHermite) {
        int* o = reinterpret_cast<int*>(col + c * kThreads);
        for (int j = 0; j < p; ++j) o[j * width] = (j * n + idx[(size_t)m * p + j]) * kPitch;
      } else {
        for (int j = 0; j <= p; ++j) col[c * kThreads + j * width] = table[(size_t)j * M + m];
      }
    }
  }

  // row table of tile t into buffer b: the p unrolled instances load their
  // inputs first (xs), so a caller can issue the loads ahead of its stores
  const int task0 = first_task();
  float xs[kTasks];
  auto load = [&](int t) {
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int task = task0 + i * kThreads, row = t * kRows + task % kRows;
      xs[i] = (task < kRows * kPr && row < N) ? X[(size_t)row * kPr + task / kRows] : 0.f;
    }
  };
  // the constants of a row: its slot's (per-row Hermite), else the shared
  auto consts_of = [&](int row) {
    return (kHermite && row_slot != nullptr) ? consts + (size_t)row_slot[row] * 3 * p : consts;
  };
  auto build = [&](int t, float* tab) {
    if (kP > 0) {
#pragma unroll
      for (int i = 0; i < kTasks; ++i) {
        const int task = task0 + i * kThreads, r = task % kRows;
        if (task < kRows * kPr && t * kRows + r < N)
          build_task<kKind>(xs[i], task / kRows, r, n, consts_of(t * kRows + r), coef, tab);
      }
    } else {
      for (int task = task0; task < kRows * p; task += kThreads) {
        const int r = task % kRows, row = t * kRows + r;
        if (row < N)
          build_task<kKind>(X[(size_t)row * p + task / kRows], task / kRows, r, n,
                            consts_of(row), coef, tab);
      }
    }
  };

  if (kP > 0) load(t_first);
  build(t_first, sh);
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    const int t = t_first + i;
    const float* tab = sh + (i & 1) * tab_floats;
    float* nxt = sh + ((i + 1) & 1) * tab_floats;
    if (kP > 0 && i + 1 < count) load(t + 1);
    float* dst = out + (size_t)t * kRows * M + m0;
    const int rows = min(kRows, N - t * kRows);
    if (kP == 0) {
      store_any<kKind, kC>(tab, col, p, ok, dst, M, rows);
    } else if (kHermite) {
      store_hermite<kPr, kC>(tab, off, ok, dst, M, rows);
    } else {
      store_rff<kPr, kC>(tab, w, ok, dst, M, rows);
    }
    if (i + 1 < count) build(t + 1, nxt);
    __syncthreads();
  }
}

using Kernel = void (*)(const float*, int, int, int, int, int, const float*,
                        const float*, const int*, const float*, const int*, float*);

template <int kKind, int kC>
Kernel instance(int p) {
  switch (p) {
    case 1: return phi_features_kernel<kKind, 1, kC>;
    case 2: return phi_features_kernel<kKind, 2, kC>;
    case 3: return phi_features_kernel<kKind, 3, kC>;
    case 4: return phi_features_kernel<kKind, 4, kC>;
    case 5: return phi_features_kernel<kKind, 5, kC>;
    case 6: return phi_features_kernel<kKind, 6, kC>;
    case 7: return phi_features_kernel<kKind, 7, kC>;
    case 8: return phi_features_kernel<kKind, kMaxP, kC>;
    default: return phi_features_kernel<kKind, 0, kC>;
  }
}

template <int kKind>
Kernel instance(int p, bool wide) {
  return wide ? instance<kKind, kWide>(p) : instance<kKind, 1>(p);
}

struct Plan {
  Kernel kernel;
  int cols, col_blocks, strips, tiles_per_block, resident;
  size_t smem;
};

// The SM count and each instance's resident blocks at its shared bytes,
// asked of the runtime once per device (a launch then asks nothing).
struct Residency {
  int sms = 0;
  size_t smem[kInstances] = {};
  int blocks[kInstances] = {};
};
Residency g_residency[kMaxDevices];
std::mutex g_residency_lock;

cudaError_t residency(int dev, Kernel kernel, int slot, size_t smem, int* blocks, int* sms) {
  std::lock_guard<std::mutex> hold(g_residency_lock);
  Residency& R = g_residency[dev];
  cudaError_t err = cudaSuccess;
  if (R.sms == 0) {
    err = cudaDeviceGetAttribute(&R.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (R.blocks[slot] == 0 || R.smem[slot] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&R.blocks[slot], kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (R.blocks[slot] < 1) return cudaErrorInvalidConfiguration;
    R.smem[slot] = smem;
  }
  *blocks = R.blocks[slot];
  *sms = R.sms;
  return cudaSuccess;
}

// The launch for N rows of M features of a `kind` tile with p inputs and
// recurrence depth n: the wide instance (8 columns a thread) where its
// grid of column blocks x 32-row tiles still fills the card once (its
// resident blocks x SMs), else one column a thread, then strips of
// tiles_per_block tiles, so the grid is at most that one wave.
cudaError_t make_plan(int N, int p, int M, int kind, int n, Plan* P) {
  if (N < 1 || p < 1 || M < 1 || (kind != repro::kHermite && kind != repro::kRff) ||
      (kind == repro::kHermite && n < 1))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const bool any_p = p > kMaxP;
  const size_t row_words = (kind == repro::kHermite) ? (size_t)p * n : (size_t)p;
  const size_t col_words = (kind == repro::kHermite) ? (size_t)p : (size_t)p + 1;
  const long long tiles = (N + kRows - 1) / kRows;
  long long cb = 0, cap = 0;
  for (int wide = 1; wide >= 0; --wide) {
    const int C = wide ? kWide : 1;
    P->kernel = (kind == repro::kHermite) ? instance<repro::kHermite>(p, wide)
                                          : instance<repro::kRff>(p, wide);
    P->smem = sizeof(float) *
              (2 * row_words * kPitch + (any_p ? col_words * C * kThreads : 0));
    err = repro::allow_smem(P->kernel, P->smem);
    if (err != cudaSuccess) return err;
    const int slot = (kind * (kMaxP + 1) + (any_p ? 0 : p)) * 2 + wide;
    int sms = 0;
    err = residency(dev, P->kernel, slot, P->smem, &P->resident, &sms);
    if (err != cudaSuccess) return err;
    P->cols = C;
    cb = (M + (long long)kThreads * C - 1) / ((long long)kThreads * C);
    cap = (long long)P->resident * sms;
    if (!wide || cb * tiles >= cap) break;
  }
  if (cb > 0x7fffffff) return cudaErrorInvalidValue;
  P->col_blocks = (int)cb;
  const long long fit = cap / cb > 1 ? cap / cb : 1;  // row strips one wave holds
  const long long per = (tiles + fit - 1) / fit;
  P->tiles_per_block = (int)per;
  P->strips = (int)((tiles + per - 1) / per);
  return cudaSuccess;
}

}  // namespace

// The plan of a launch: threads, rows a tile, columns a thread, column
// blocks, row strips, tiles a block, blocks, shared bytes a block and the
// resident blocks per SM the card gives it.
extern "C" int repro_phi_features_plan(int N, int p, int M, int kind, int n,
                                       long long* out) {
  Plan P;
  const cudaError_t err = make_plan(N, p, M, kind, n, &P);
  if (err != cudaSuccess) return (int)err;
  const long long vals[9] = {kThreads, kRows, P.cols, P.col_blocks, P.strips,
                             P.tiles_per_block, (long long)P.col_blocks * P.strips,
                             (long long)P.smem, P.resident};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

// row_slot: null (every row under `consts` (p, 3)), or (N,) int32 slots
// into a (C, p, 3) `consts` (Hermite only; the caller keeps them in range);
// last, so a caller that passes no slots binds as before.
extern "C" int repro_phi_features(const float* X, int N, int p, int M, int kind,
                                  int n, const float* consts, const float* coef,
                                  const int* idx, const float* table, float* out,
                                  void* stream, const int* row_slot) {
  if (row_slot != nullptr && kind != repro::kHermite) return (int)cudaErrorInvalidValue;
  Plan P;
  const cudaError_t err = make_plan(N, p, M, kind, n, &P);
  if (err != cudaSuccess) return (int)err;
  P.kernel<<<dim3(P.col_blocks, P.strips), kThreads, P.smem, (cudaStream_t)stream>>>(
      X, N, p, M, n, P.tiles_per_block, consts, coef, idx, table, row_slot, out);
  return (int)cudaGetLastError();
}
