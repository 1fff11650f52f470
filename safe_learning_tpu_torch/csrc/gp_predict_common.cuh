// Shared body of the fused GP-predict kernels for Hopper (sm_90a).
//
// Both kernels, the stationary one (gp_predict.cu) and the covariance-
// program one (gp_predict_program.cuh), compute for every query q and
// every output, over the n = count active rows of a GP of capacity cap,
//
//   k_j       = k(x_j, q) * scale^2 * mask_j            (j < n)
//   a         = chol_inv[:n, :n] * k          (chol_inv lower-triangular)
//   mean[q,:] = a^T alpha[:n]                 (p outputs)
//   var[q]    = sum_i a_i^2
//
// and differ only in how k(x_j, q) is formed. This header holds what they
// share: the covariance formulas and two solve bodies. Together they
// replace the body the three Pallas TPU kernels of
// safe_learning_tpu/ops/gp_kernel.py share (`_gp_predict_kernel` :169,
// `_gp_predict_kernel_general` :271, `_gp_predict_kernel_stacked` :347):
// per query tile, k assembled in VMEM, then a = chol_inv @ k and
// alpha^T a as full-capacity MXU matmuls and sum a^2 on the VPU.
//
// Why only n rows. The GP's mask is the prefix arange(cap) < count, and
// the host factorization pads rows count..cap of chol_inv with the
// identity, so chol_inv[count:, :count] == 0 and mask[count:] == 0: every
// term a row or column at or past count adds is an exact zero. The loops
// stop at n; the rows that are kept see the same FMAs in the same
// ascending-j order as over the full capacity.
//
// What bounds it on the H100. At n = 128 a query costs n (n + 1) / 2 =
// 8,256 FMAs for a = L^-1 k, about 1.3k operations for k and n (p + 1)
// FMAs for the reductions, while it moves (d + p + 1) values. So it is
// bound by FP32 arithmetic on the CUDA cores (67 TFLOP/s; TF32 is not
// allowed on this path) and by the shared-memory traffic that feeds the
// FMAs, never by device memory. At small counts the n evaluations of k
// per query and output (an exp, often a sqrt) outweigh the solve.
//
// The tiled body (n <= 128, solve_tile and its helpers):
//   - a bucket NB in {16, 32, 64, 128} is chosen at launch from n and is a
//     template parameter: small counts get tiles wide in queries (TQ = 256
//     at NB <= 32, 128 at 64, 64 at 128) and short in rows;
//   - a persistent grid (SMs x resident blocks) loops over query tiles.
//     Each block stages chol_inv[:n, :n] transposed (Ls[j][i]) in shared
//     memory once, for all S outputs where they fit, else one output per
//     tile, and the active rows of x and of the mask. The staging
//     transposes, so it uses plain loads: it runs once per block;
//   - per tile and output, all threads evaluate K[0:n, TQ] once into
//     shared memory (layout [j][q]), several rows in flight per thread;
//   - A = L^-1 K is a register-blocked outer product: a warp is 4 row
//     lanes x 8 query lanes, each thread owns a TM x TN = 4 x 4 tile of A
//     and per step j reads one 16-byte vector of an L^-1 column and one of
//     a K row for 16 FMAs. Each such load delivers 512 bytes to the warp,
//     4 of the SM's 128-byte shared-memory cycles, against 4 cycles of
//     FMAs for the step's 16: the two loads hold the solve to about half
//     the FP32 rate. An 8 x 8 tile would balance the two, but at
//     NB = 128 it needs a 128-query K tile beside the resident chol_inv,
//     which leaves one block per SM. A warp owns 16-row tiles; the
//     triangular skip stops its j loop at min(n, r0 + 16). Warps take row
//     tiles in pairs (g, RT-1-g) so every warp of a block does the same
//     work;
//   - the epilogue reduces each thread's rows into alpha^T A and sum A^2
//     one column at a time, then over the row lanes by shuffles and over
//     the warps of a query group in shared memory, and stores with
//     consecutive threads on consecutive queries;
//   - float32 tiles short in rows (NB <= 64) keep three blocks on an SM,
//     so that one block's k evaluation overlaps another's solve.
// The streamed body (n > 128, or a block that does not fit in shared
// memory; solve_streamed): one query per thread, the chol_inv row tile
// staged transposed, and k recomputed in chunks of CB columns, so any
// count up to kernel_max_capacity = 2048 runs in a fixed amount of shared
// memory.
//
// Precision: FP32 (or FP64) FMAs on the CUDA cores, no fast-math, library
// expf/exp. A's sums keep the ascending-j order; the reductions' order
// differs from the plain twin's and stays inside the computed bounds.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace gp_common {

constexpr int D_MAX = 16;  // largest input dimension
constexpr int P_MAX = 8;   // largest number of outputs of one GP

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// The formulas of STATIONARY_COVARIANCES (functions/gp.py), 1e-36 guards
// included: normalized covariance from the squared scaled distance.
template <typename T>
__device__ __forceinline__ T cov_rbf(T r2) {
  return dev_exp(T(-0.5) * r2);
}
template <typename T>
__device__ __forceinline__ T cov_matern12(T r2) {
  return dev_exp(-dev_sqrt(r2 + T(1e-36)));
}
template <typename T>
__device__ __forceinline__ T cov_matern32(T r2) {
  T r = dev_sqrt(T(3) * r2 + T(1e-36));
  return (T(1) + r) * dev_exp(-r);
}
template <typename T>
__device__ __forceinline__ T cov_matern52(T r2) {
  T r = dev_sqrt(T(5) * r2 + T(1e-36));
  return (T(1) + r + r * r / T(3)) * dev_exp(-r);
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// dst[0..N) from 16-byte-aligned shared memory, as 16-byte vectors.
template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N],
                                         const float* src) {
#pragma unroll
  for (int v = 0; v < N / 4; ++v) {
    const float4 w = reinterpret_cast<const float4*>(src)[v];
    dst[4 * v] = w.x;
    dst[4 * v + 1] = w.y;
    dst[4 * v + 2] = w.z;
    dst[4 * v + 3] = w.w;
  }
}
template <int N>
__device__ __forceinline__ void load_vec(double (&dst)[N],
                                         const double* src) {
#pragma unroll
  for (int v = 0; v < N / 2; ++v) {
    const double2 w = reinterpret_cast<const double2*>(src)[v];
    dst[2 * v] = w.x;
    dst[2 * v + 1] = w.y;
  }
}

// Query row qi's first d coordinates. A row past the ragged end reads the
// last query; its results are computed and not stored.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ q,
                                         int64_t qi, int64_t n_q, int d,
                                         T (&qv)[D_MAX]) {
  const int64_t row = qi < n_q ? qi : n_q - 1;
#pragma unroll
  for (int c = 0; c < D_MAX; ++c) qv[c] = c < d ? q[row * d + c] : T(0);
}

// ---------------------------------------------------------------------------
// Tiled body: n <= N_TILED_MAX
// ---------------------------------------------------------------------------
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int TM = 4;            // rows of A per thread
constexpr int TN = 4;            // queries per thread
constexpr int WC = 8;            // query lanes of a warp
constexpr int WR = 32 / WC;      // row lanes of a warp
constexpr int WT = WR * TM;      // rows of a warp's tile
constexpr int N_TILED_MAX = 128;
// Dynamic shared memory a block may use on the H100.
constexpr size_t SMEM_MAX = 232448;

// Shape of bucket NB: RT row tiles of WT rows; WG warps share a query
// group, each taking the row tiles g and RT-1-g (H halves); TQ queries per
// tile; SLOTS partial sums per query, one per (warp, half).
template <int NB>
struct Tile {
  static_assert(NB % WT == 0 && NB <= N_TILED_MAX, "bucket");
  static constexpr int RT = NB / WT;
  static constexpr int WG = RT > 1 ? RT / 2 : 1;
  static constexpr int H = RT > 1 ? 2 : 1;
  static constexpr int TQ = NW / WG * WC * TN;
  static constexpr int SLOTS = WG * H;
};

// Row stride of the staged, transposed chol_inv: NB values plus 16 bytes,
// so every row starts 16-byte aligned.
template <typename T>
__host__ __device__ constexpr int ls_stride(int nb) {
  return nb + 16 / (int)sizeof(T);
}

// Dynamic shared memory of one tiled block: chol_inv of n_res outputs,
// the [NB][TQ] k tile, the [SLOTS][p + 1][TQ] partial sums, and the
// active rows of x ([NB][d]) and of the mask.
template <typename T, int NB>
__host__ __device__ constexpr size_t tiled_smem_bytes(int n_res, int p,
                                                      int d) {
  return sizeof(T) *
         ((size_t)n_res * NB * ls_stride<T>(NB) + (size_t)NB * Tile<NB>::TQ +
          (size_t)Tile<NB>::SLOTS * (p + 1) * Tile<NB>::TQ +
          (size_t)NB * (d + 1));
}

// Pointers into a tiled block's shared memory (see tiled_smem_bytes).
template <typename T, int NB>
struct TiledSmem {
  T *ls, *ks, *red, *xs, *ms;
  __device__ __forceinline__ TiledSmem(unsigned char* raw, int n_res, int p,
                                       int d)
      : ls(reinterpret_cast<T*>(raw)),
        ks(ls + n_res * NB * ls_stride<T>(NB)),
        red(ks + NB * Tile<NB>::TQ),
        xs(red + Tile<NB>::SLOTS * (p + 1) * Tile<NB>::TQ),
        ms(xs + NB * d) {}
};

// Stage chol_inv[:n, :n] (row stride cap) transposed: ls[j][i] for j < n
// and i < NB, zero for i >= n. Reads along a row are coalesced.
template <typename T, int NB>
__device__ __forceinline__ void stage_chol_inv(
    T* ls, const T* __restrict__ chol_inv, int cap, int n) {
  constexpr int LS = ls_stride<T>(NB);
  if (n == 0) return;
  for (int idx = threadIdx.x; idx < NB * n; idx += NT) {
    const int i = idx / n;
    const int j = idx - i * n;
    ls[j * LS + i] = i < n ? chol_inv[(int64_t)i * cap + j] : T(0);
  }
}

// Stage the active rows of x (n x d, row-major) and of the mask.
template <typename T>
__device__ __forceinline__ void stage_rows(T* xs, T* ms,
                                           const T* __restrict__ x,
                                           const T* __restrict__ mask, int n,
                                           int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += NT) xs[idx] = x[idx];
  for (int j = threadIdx.x; j < n; j += NT) ms[j] = mask[j];
}

// ks[j][ql] = kfn(j) for j < n, where ql is this thread's query in the
// tile (threadIdx.x % TQ) and kfn evaluates k for that query.
template <typename T, int NB, class KFn>
__device__ __forceinline__ void fill_k(T* ks, const KFn& kfn, int n) {
  constexpr int TQ = Tile<NB>::TQ;
  constexpr int JS = NT / TQ;  // threads per query
  const int ql = threadIdx.x % TQ;
  // Unrolled so that several rows' covariances are in flight at once.
#pragma unroll 4
  for (int j = threadIdx.x / TQ; j < n; j += JS) ks[j * TQ + ql] = kfn(j);
}

// Blocks of a tiled kernel that should fit on one SM: three where the
// tile is short in rows (float32, NB <= 64), so that one block's k
// evaluation overlaps another's solve; else two, or one in float64.
template <typename T, int NB>
__host__ __device__ constexpr int tiled_min_blocks() {
  return sizeof(T) == 4 ? (NB <= 64 ? 3 : 2) : 1;
}

// part[c] summed over the WR row lanes (lane bits above the query lanes);
// the lanes of row lane 0 write it to dst[c].
template <typename T>
__device__ __forceinline__ void reduce_rows(T (&part)[TN], T* dst, int lr) {
#pragma unroll
  for (int off = WC; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
    }
  }
  if (lr == 0) {
#pragma unroll
    for (int c = 0; c < TN; ++c) dst[c] = part[c];
  }
}

// A = L^-1 K over the active rows, row tile by row tile. After each row
// tile the thread's rows are reduced into alpha^T A and sum A^2 one
// column at a time, then over the row lanes, and written to the tile's
// partial sums red[slot][c][q] (c < p: mean, c == p: var), one slot per
// warp and row tile.
template <typename T, int NB>
__device__ __forceinline__ void solve_tile(const T* ks, const T* ls,
                                           T* red,
                                           const T* __restrict__ alpha,
                                           int n, int p) {
  constexpr int LS = ls_stride<T>(NB);
  constexpr int TQ = Tile<NB>::TQ;
  constexpr int RT = Tile<NB>::RT;
  constexpr int WG = Tile<NB>::WG;
  constexpr int H = Tile<NB>::H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lc = lane % WC;
  const int lr = lane / WC;
  const int grp = warp / WG;
  const int wg = warp - grp * WG;
  const int qcol = grp * (WC * TN) + lc * TN;

#pragma unroll 1
  for (int half = 0; half < H; ++half) {
    const int g = half == 0 ? wg : RT - 1 - wg;
    const int r0 = g * WT;
    // Rows past the count: A is zero there and the j loop is empty.
    const int jend = r0 < n ? min(n, r0 + WT) : 0;
    T acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = T(0);
    }
    const T* lp = ls + r0 + lr * TM;
    const T* kp = ks + qcol;
#pragma unroll 4
    for (int j = 0; j < jend; ++j) {
      T l[TM], k[TN];
      load_vec(l, lp + j * LS);
      load_vec(k, kp + j * TQ);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] += l[r] * k[c];
      }
    }

    T* slot = red + (int64_t)(wg * H + half) * (p + 1) * TQ + qcol;
    T part[TN];
    // Rows at or past n hold exact zeros (their chol_inv rows are staged
    // as zeros), so they add nothing to sum A^2.
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      part[c] = T(0);
#pragma unroll
      for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * acc[r][c];
    }
    reduce_rows(part, slot + p * TQ, lr);
#pragma unroll 1
    for (int o = 0; o < p; ++o) {
      T a[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = r0 + lr * TM + r;
        a[r] = i < n ? __ldg(alpha + (int64_t)i * p + o) : T(0);
      }
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        part[c] = T(0);
#pragma unroll
        for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * a[r];
      }
      reduce_rows(part, slot + o * TQ, lr);
    }
  }
}

// Sum the SLOTS partials of each query of the tile starting at q0 and
// store output `out` of n_out: mean_out[(q * n_out + out) * p + c] and
// var_out[q * n_out + out], consecutive threads on consecutive queries.
template <typename T, int NB>
__device__ __forceinline__ void store_tile(const T* red, int64_t q0,
                                           int64_t n_q, int p, int n_out,
                                           int out, T* __restrict__ mean_out,
                                           T* __restrict__ var_out) {
  constexpr int TQ = Tile<NB>::TQ;
  constexpr int SLOTS = Tile<NB>::SLOTS;
  for (int idx = threadIdx.x; idx < TQ * (p + 1); idx += NT) {
    const int c = idx / TQ;
    const int ql = idx - c * TQ;
    const int64_t qi = q0 + ql;
    if (qi >= n_q) continue;
    T sum = red[c * TQ + ql];
#pragma unroll
    for (int w = 1; w < SLOTS; ++w) sum += red[(w * (p + 1) + c) * TQ + ql];
    if (c < p) {
      mean_out[(qi * n_out + out) * p + c] = sum;
    } else {
      var_out[qi * n_out + out] = sum;
    }
  }
}

// What the launches of one tiled instantiation ask of the CUDA runtime,
// asked once per device and dynamic shared-memory size: the grid's resident
// slots (SMs x blocks per SM). On a miss the kernel's shared-memory opt-in
// is raised to the largest size seen on that device, never lowered, so
// every size already cached stays allowed. Each instantiation's launcher
// holds one as a function-local static.
struct GridCache {
  static constexpr int N = 16;
  std::mutex lock;
  int n = 0;
  int dev[N];
  size_t smem[N];
  int64_t slots[N];
};

// Blocks of a persistent grid: one per resident slot on every SM, at most
// one per query tile. A launch whose (device, size) is cached makes no CUDA
// call but cudaGetDevice.
template <class Kernel>
inline cudaError_t persistent_grid(GridCache& cache, Kernel kernel,
                                   size_t smem, int64_t n_q, int tq,
                                   int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int64_t slots = 0;
  {
    std::lock_guard<std::mutex> guard(cache.lock);
    size_t opt_in = smem;
    for (int i = 0; i < cache.n; ++i) {
      if (cache.dev[i] != dev) continue;
      if (cache.smem[i] == smem) slots = cache.slots[i];
      if (cache.smem[i] > opt_in) opt_in = cache.smem[i];
    }
    if (slots == 0) {
      int sms = 0, per_sm = 0;
      // Above 48 KB a launch is refused unless the kernel opts in.
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)opt_in);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NT, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      slots = (int64_t)sms * per_sm;
      // A full cache asks again next time.
      if (cache.n < GridCache::N) {
        cache.dev[cache.n] = dev;
        cache.smem[cache.n] = smem;
        cache.slots[cache.n] = slots;
        ++cache.n;
      }
    }
  }
  const int64_t tiles = (n_q + tq - 1) / tq;
  *grid = (int)(tiles < slots ? tiles : slots);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Streamed body: n > N_TILED_MAX
// ---------------------------------------------------------------------------
constexpr int NTS = 128;  // threads (queries) per streamed block
constexpr int RB = 32;    // rows of a held in registers at a time
constexpr int CB = 128;   // k columns staged in shared memory

// Row stride of the staged chol_inv row tile: RB values plus 16 bytes.
template <typename T>
__host__ __device__ constexpr int tile_stride() {
  return RB + 16 / (int)sizeof(T);
}

// Dynamic shared memory of one streamed block: k for NTS queries and the
// chol_inv tile, CB columns each.
template <typename T>
__host__ __device__ constexpr size_t streamed_smem_bytes() {
  return (size_t)CB * (NTS + tile_stride<T>()) * sizeof(T);
}

// acc[base + i] += w_i * kj for the lanes of one 16-byte vector.
__device__ __forceinline__ void fma_vec(float (&acc)[RB], int base,
                                        float4 w, float kj) {
  acc[base] += w.x * kj;
  acc[base + 1] += w.y * kj;
  acc[base + 2] += w.z * kj;
  acc[base + 3] += w.w * kj;
}
__device__ __forceinline__ void fma_vec(double (&acc)[RB], int base,
                                        double2 w, double kj) {
  acc[base] += w.x * kj;
  acc[base + 1] += w.y * kj;
}

// One output of one query per thread: a = chol_inv[:n, :n] * k, then
// macc[c] += sum_i a_i alpha[i, c] and vacc += sum_i a_i^2.
//
// kfn(j) returns this thread's k_j, already scaled and masked. ks is the
// block's [CB][NTS] k buffer, ls its [CB][tile_stride] chol_inv tile. The
// k slice a row block needs is recomputed in chunks of CB columns. Every
// thread of the block must call this (it synchronises the block to stage
// the tiles).
template <typename T, class KFn>
__device__ __forceinline__ void solve_streamed(
    T* ks, T* ls, const KFn& kfn, const T* __restrict__ chol_inv,
    const T* __restrict__ alpha, int cap, int n, int p, T (&macc)[P_MAX],
    T& vacc) {
  using V = typename Vec16<T>::type;
  constexpr int LS = tile_stride<T>();
  constexpr int VN = 16 / (int)sizeof(T);  // lanes per vector
  const int tid = threadIdx.x;

  for (int r0 = 0; r0 < n; r0 += RB) {
    const int nr = min(RB, n - r0);
    const int row_end = r0 + nr;
    T acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = T(0);

    // Columns 0 .. row_end-1: everything right of the block is zero.
    for (int j0 = 0; j0 < row_end; j0 += CB) {
      const int jn = min(CB, row_end - j0);
      __syncthreads();  // the previous tile has been read
      // Stage rows r0..r0+RB, columns j0..j0+jn of chol_inv, transposed
      // (ls[j][r]); reads along a row are coalesced, rows past n are 0.
      for (int idx = tid; idx < RB * jn; idx += NTS) {
        const int r = idx / jn;
        const int j = idx - r * jn;
        ls[j * LS + r] =
            r < nr ? chol_inv[(int64_t)(r0 + r) * cap + j0 + j] : T(0);
      }
      for (int j = 0; j < jn; ++j) ks[j * NTS + tid] = kfn(j0 + j);
      __syncthreads();

      for (int j = 0; j < jn; ++j) {
        const T kj = ks[j * NTS + tid];
        const V* lcol = reinterpret_cast<const V*>(ls + j * LS);
#pragma unroll
        for (int v = 0; v < RB / VN; ++v) fma_vec(acc, v * VN, lcol[v], kj);
      }
    }

#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nr) {
        const T a = acc[r];
        vacc += a * a;
        const T* arow = alpha + (int64_t)(r0 + r) * p;
#pragma unroll
        for (int c = 0; c < P_MAX; ++c) {
          if (c < p) macc[c] += a * __ldg(arow + c);
        }
      }
    }
  }
}

}  // namespace gp_common
