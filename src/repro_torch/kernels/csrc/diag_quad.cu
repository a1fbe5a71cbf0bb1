// Diagonal of a quadratic form: var_i = a_i^T C a_i = sum_l (A C)_il A_il
// for A (N, M), C (M, M), without the N x N matrix A C A^T and without the
// N x M product A C in memory.  C need not be symmetric.
//
// Replaces the TPU kernel repro/kernels/diag_quad.py::diag_quad_kernel.
//
// Bound on the H100: float32 operations.  One serving microbatch (N = 128,
// M = 14,641) is 2 N M^2 = 5.5e10 flops against one 857 MB read of C, so
// the 67 TFLOP/s float32 rate bounds it (0.82 ms) ahead of the 3.35 TB/s
// read (0.26 ms).
//
// Design, for the FP32 rate:
//  * A block owns a 128 x 128 tile T = A[rows] C[k range, strip]: one
//    128-column strip of C against all 128 rows of a microbatch, so C is
//    read exactly once (a second row tile only where N > 128).  Each of its
//    256 threads holds an 8 x 8 register tile: four float4 shared loads
//    feed 64 FMAs.
//  * A and C stream through a 3-stage cp.async ring of 32-deep slices
//    (96 KB of dynamic shared memory, one __syncthreads per slice).  Both
//    are copied 4 bytes at a time (C's rows start at any 4-byte offset when
//    M is odd), masked by zero-fill past N and M.  A is stored k-major with
//    an XOR swizzle of its row index (bits 2-4 by k mod 8), so both the
//    copies and the float4 reads are free of bank conflicts.
//  * Split-K: M / 128 strips alone do not fill the card (115 at M =
//    14,641), so the k axis is cut into S parts, S chosen from the
//    occupancy so that strips x S fills whole waves of resident blocks.
//  * Epilogue: rowsum(T * A[rows, strip]) in registers, then warp shuffles,
//    one partial per row and block into a (strips x S, N) scratch the
//    wrapper allocates; a second, tiny kernel sums the partials in a fixed
//    order (deterministic, no atomics).
#include "expansion.cuh"

namespace {

constexpr int kTile = 128;   // rows and columns of a block's tile
constexpr int kDepth = 32;   // k per pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageFloats = 2 * kDepth * kTile;  // A slice, then C slice
constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats;  // 98,304 B

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// column of A's row r at depth k in the stage (keeps groups of 4 rows)
__device__ __forceinline__ int swz(int k, int r) { return r ^ ((k & 7) << 2); }

// What one thread copies of every slice, fixed for the block: 4 rows of A
// (rows (warp * 4 + j) * 4 + lane / 8) at 4 depths (q * 8 + lane % 8),
// and 16 entries of one column of C (depths lane-major: tid / 128 + 2 i).
struct StageCopy {
  const float* arow[4];  // A + row * M, or A where the row is past N
  const float* ccol;     // C + (tid / 128) * M + column, or C past M
  int adst[4];           // As offset of (depth lane % 8, row j)
  int cdst;              // Cs offset of (depth tid / 128, column)
  int ak, ck;            // first depth of this thread's A and C copies
  bool aok[4], cok;
};

__device__ __forceinline__ StageCopy stage_copy(const float* __restrict__ A,
                                                const float* __restrict__ C, int N,
                                                int M, int r0, int l0, int tid) {
  StageCopy sc;
  const int warp = tid >> 5, lane = tid & 31;
  sc.ak = lane & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (warp * 4 + j) * 4 + (lane >> 3);
    sc.aok[j] = r0 + r < N;
    sc.arow[j] = sc.aok[j] ? A + (size_t)(r0 + r) * M : A;
    sc.adst[j] = sc.ak * kTile + swz(sc.ak, r);
  }
  const int c = tid % kTile;
  sc.ck = tid / kTile;
  sc.cok = l0 + c < M;
  sc.ccol = sc.cok ? C + (size_t)sc.ck * M + l0 + c : C;
  sc.cdst = sc.ck * kTile + c;
  return sc;
}

// One 32-deep slice at k0: As[k][swz(k, r)] = A[r0 + r, k0 + k],
// Cs[k][c] = C[k0 + k, l0 + c], zero past N and M.  swz(k, r) depends on
// k only through k % 8, which a thread's A copies share.  A block wholly
// inside A and C copies without the masks (kMasked = false).
template <bool kMasked>
__device__ __forceinline__ void load_stage(float* st, const StageCopy& sc, int M,
                                           int k0) {
  float* As = st;
  float* Cs = st + kDepth * kTile;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* a = sc.arow[j] + k0 + sc.ak;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = !kMasked || (sc.aok[j] && k0 + q * 8 + sc.ak < M);
      cp_async4(As + sc.adst[j] + q * 8 * kTile, ok ? a + q * 8 : sc.arow[j], ok);
    }
  }
  const float* cp = sc.ccol + (size_t)k0 * M;
#pragma unroll
  for (int i = 0; i < kDepth * kTile / kThreads; ++i) {
    const bool ok = !kMasked || (sc.cok && k0 + sc.ck + 2 * i < M);
    cp_async4(Cs + sc.cdst + i * 2 * kTile, ok ? cp : sc.ccol, ok);
    cp += 2 * (size_t)M;
  }
}

// Block (strip * S + s, row tile): slices [s spb, (s + 1) spb) of the k axis.
__global__ void __launch_bounds__(kThreads, 2)
diag_quad_partial(const float* __restrict__ A, const float* __restrict__ C, int N,
                  int M, int S, int spb, float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int strip = blockIdx.x / S, s = blockIdx.x % S;
  const int l0 = strip * kTile, r0 = blockIdx.y * kTile;
  const int nslices = (M + kDepth - 1) / kDepth;
  const int sl0 = s * spb;
  const int n = max(0, min(nslices, sl0 + spb) - sl0);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // rows ty*4 + u and 64 + ty*4 + u; columns tx*4 + v and 64 + tx*4 + v
  const StageCopy sc = stage_copy(A, C, N, M, r0, l0, tid);
  const bool inside = r0 + kTile <= N && l0 + kTile <= M && (sl0 + n) * kDepth <= M;
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) {
      if (inside)
        load_stage<false>(sm + i * kStageFloats, sc, M, (sl0 + i) * kDepth);
      else
        load_stage<true>(sm + i * kStageFloats, sc, M, (sl0 + i) * kDepth);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_async_wait<kStages - 2>();  // slice `it` has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and slice it - 1 is consumed
    const int nx = it + kStages - 1;
    if (nx < n) {
      if (inside)
        load_stage<false>(sm + (nx % kStages) * kStageFloats, sc, M, (sl0 + nx) * kDepth);
      else
        load_stage<true>(sm + (nx % kStages) * kStageFloats, sc, M, (sl0 + nx) * kDepth);
    }
    cp_async_commit();
    const float* As = sm + (it % kStages) * kStageFloats;
    const float* Cs = As + kDepth * kTile;
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * kTile + swz(k, ty * 4));
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * kTile + swz(k, 64 + ty * 4));
      const float4 c0 = *reinterpret_cast<const float4*>(Cs + k * kTile + tx * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(Cs + k * kTile + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], cv[v], acc[u][v]);
    }
  }
  cp_async_wait<0>();

  // rowsum over the strip of T * A; the 16 threads sharing a ty are 16
  // consecutive lanes of one warp
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gr = r0 + (u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4);
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gl = l0 + (v < 4 ? tx * 4 + v : 64 + tx * 4 + v - 4);
      if (gr < N && gl < M) sum = fmaf(acc[u][v], A[(size_t)gr * M + gl], sum);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0 && gr < N) partial[(size_t)blockIdx.x * N + gr] = sum;
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

struct DqPlan {
  int strips, S, spb, rowtiles, resident;
};

// S: the split of the k axis that takes the fewest slice-times, counting
// whole waves of resident blocks and one slice of fill and epilogue per
// block.
cudaError_t dq_plan(int N, int M, DqPlan* plan) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = repro::allow_smem(diag_quad_partial, kSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, diag_quad_partial, kThreads, kSmem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const int resident = occ * sms;
  const int strips = (M + kTile - 1) / kTile, rowtiles = (N + kTile - 1) / kTile;
  const int nslices = (M + kDepth - 1) / kDepth;
  DqPlan best{strips, 1, nslices, rowtiles, resident};
  long long best_cost = -1;
  for (int s = 1; s <= nslices && s <= 64; ++s) {
    const int spb = (nslices + s - 1) / s;
    const int S = (nslices + spb - 1) / spb;  // no empty parts
    const long long blocks = (long long)strips * S * rowtiles;
    const long long waves = (blocks + resident - 1) / resident;
    const long long cost = waves * (spb + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = DqPlan{strips, S, spb, rowtiles, resident};
    }
  }
  *plan = best;
  return cudaSuccess;
}

}  // namespace

// out = {strips, S, slices per part, row tiles, resident blocks}; the
// wrapper allocates a (strips * S, N) float scratch.
extern "C" int repro_diag_quad_plan(int N, int M, int* out) {
  DqPlan plan;
  const cudaError_t err = dq_plan(N, M, &plan);
  if (err != cudaSuccess) return (int)err;
  out[0] = plan.strips;
  out[1] = plan.S;
  out[2] = plan.spb;
  out[3] = plan.rowtiles;
  out[4] = plan.resident;
  return 0;
}

// `S` and `spb` as repro_diag_quad_plan gave them.
extern "C" int repro_diag_quad(const float* A, const float* C, int N, int M, int S,
                               int spb, float* partial, float* out, void* stream) {
  const int strips = (M + kTile - 1) / kTile;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = repro::allow_smem(diag_quad_partial, kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(strips * S, (N + kTile - 1) / kTile);
  diag_quad_partial<<<grid, kThreads, kSmem, st>>>(A, C, N, M, S, spb, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  diag_quad_reduce<<<(N + 255) / 256, 256, 0, st>>>(partial, N, strips * S, out);
  return (int)cudaGetLastError();
}
