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
// share: the covariance formulas and three solve bodies. Together they
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
// What bounds it on the H100. Per query and output the solve needs
// n (n + 1) / 2 FMAs, the evaluation of k n covariances (an exp, often a
// sqrt) and the reductions n (p + 1) FMAs, while the query moves
// (d + p + 1) values. At n = 128 that is 8,256 solve FMAs, at the adaptive
// example's n = 181 16,471 (65,522 FP32 operations a query for its S = 2
// outputs, against 28 bytes). So it is bound by FP32 arithmetic on the
// CUDA cores (67 TFLOP/s; TF32 is not allowed on this path) and by the
// shared-memory loads that feed the FMAs, never by device memory. At small
// counts the n evaluations of k per query and output outweigh the solve.
//
// Three bodies, chosen by shape alone (count, dtype, p, d): the tiled body
// up to N_TILED_MAX = 128 rows, the panel body above it up to
// Panel<T>::N_MAX (512 rows in float32, 256 in float64; kernels 2 and 3),
// and the streamed body above that (and for kernel 1 above 128 rows).
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
//
// The panel body (128 < n <= Panel<T>::N_MAX, or a tiled block that does
// not fit; panel_fetch, panel_chunk, panel_reduce and the kernel
// gp_program_panel of gp_predict_program.cuh) is the streamed body
// redesigned for this card. It answers the six causes that held the
// streamed body to a tenth of its bound at n = 181:
//   1. k was recomputed for every 32-row block (661 evaluations a query
//      and output at n = 181 where 181 are needed): here a block
//      evaluates K[0:n, TQ] once per query tile and output into shared
//      memory (TQ = 64 queries, 4 threads a query, several rows in flight),
//      and the solve reads it from there;
//   2. it ran square 32-row blocks over 32 accumulator lanes: here a warp
//      owns a 16-row tile and stops its j loop at min(n, r0 + 16), 19,792
//      FMAs a query and output at n = 181 against 21,152 (16,471 needed);
//   3. 8 warps an SM (83,968 B a block of 128 threads): here a block of
//      256 threads needs 89,088 B at the adaptive shape (float32,
//      n = 181, p = 1, d = 3): two blocks, 16 warps an SM;
//   4. chol_inv tiles were restaged with plain loads behind two barriers:
//      here chol_inv streams through a ring of NSLOT = 2 shared-memory
//      slots of PROWS x JC values (a 64-row panel, 256 bytes of columns in
//      float32, 128 in float64) filled by cp.async, the next tile in
//      flight while the block solves this one (64 j steps), one barrier a
//      tile. Tiles past the
//      diagonal are never copied; elements above it, or past the count,
//      are zero-filled by the copy (src-size 0), so nothing reads them.
//      chol_inv rows are cap values apart, which for cap = 181 is not 16
//      bytes, so the copies are element-wise (4 or 8 bytes) and the slot
//      stays row-major: a thread reads its TM rows as 16-byte vectors
//      along j, four j steps at a time, with a stride of JC + 16 bytes.
//      In a quarter-warp the 8 query lanes read one row vector
//      (a broadcast) and 8 consecutive K vectors, so no load conflicts.
//      A transposed copy of chol_inv kept beside the GP would allow
//      16-byte copies, but every place that changes the factor (the host
//      factorization, add_data_point, the device append) would have to
//      refresh it;
//   5. each output formed the query's differences anew: here the
//      differences are formed once per row and output within the K fill,
//      as the tiled body does. Sharing them across the S outputs as well
//      would need S K tiles at once, and two at n = 181 leave one block
//      per SM; the differences are 3 of the flagship program's ~20
//      operations a row, so the outputs keep one K tile and take turns;
//   6. one query a thread and 128 a block left a sampler step (about
//      2,000 rows) on 16 blocks: here the persistent grid walks
//      (query tile, output) items, 64 queries each, so such a step
//      fills 64 blocks.
// The register tile stays 4 x 4 (TM x TN), as in the tiled body: per four
// j steps a thread loads TM row vectors of L^-1 and 4 K vectors (TN / 4
// each) for 64 FMAs. Each warp-wide 16-byte load costs up to 4 of the
// SM's shared-memory cycles, so the loads bound the solve to about half
// the FP32 rate; a wider tile loads less but needs a taller row panel or
// a wider query tile, which at n = 181 idles warps past the count or
// leaves one block per SM. Per panel, each warp reduces its rows into
// alpha^T A and sum A^2 and adds them to its own partial-sum slot; after
// the last panel the slots are summed and stored, consecutive threads on
// consecutive queries. The shape was chosen on the card (H100 80GB HBM3,
// 700 W) by timing builds of other shapes at n = 181 (PERF.md): 8 x 4 and
// 4 x 8 tiles took 1.37-1.47x the 4 x 4 tile's time; 256-byte chunks in
// two slots 0.955x that of 128-byte chunks in three; rows interleaved
// across the row lanes and three blocks an SM gained 1-2 %, too little to
// keep a second layout.
//
// The streamed body (solve_streamed; kernel 1 above 128 rows and its
// variants, kernels 2 and 3 above Panel<T>::N_MAX): one query per thread,
// the chol_inv row tile staged transposed, and k recomputed in chunks of
// CB columns, so any count up to kernel_max_capacity = 2048 runs in a
// fixed amount of shared memory.
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

// Shape of bucket NB in a block of NTH threads: RT row tiles of WT rows;
// WG warps share a query group, each taking the row tiles g and RT-1-g (H
// halves); TQ queries per tile; SLOTS partial sums per query, one per
// (warp, half). Kernels 1-3 run NT threads; a narrower block gives a
// narrower tile (the float64 variants of gp_predict_variants.cu).
template <int NB, int NTH = NT>
struct Tile {
  static_assert(NB % WT == 0 && NB <= N_TILED_MAX, "bucket");
  static constexpr int RT = NB / WT;
  static constexpr int WG = RT > 1 ? RT / 2 : 1;
  static constexpr int H = RT > 1 ? 2 : 1;
  static_assert(NTH % 32 == 0 && (NTH / 32) % WG == 0, "warps per tile");
  static constexpr int TQ = NTH / 32 / WG * WC * TN;
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
template <typename T, int NB, int NTH = NT>
__device__ __forceinline__ void stage_chol_inv(
    T* ls, const T* __restrict__ chol_inv, int cap, int n) {
  constexpr int LS = ls_stride<T>(NB);
  if (n == 0) return;
  for (int idx = threadIdx.x; idx < NB * n; idx += NTH) {
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
template <typename T, int NB, int NTH = NT, class KFn>
__device__ __forceinline__ void fill_k(T* ks, const KFn& kfn, int n) {
  constexpr int TQ = Tile<NB, NTH>::TQ;
  constexpr int JS = NTH / TQ;  // threads per query
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
template <typename T, int NB, int NTH = NT>
__device__ __forceinline__ void solve_tile(const T* ks, const T* ls,
                                           T* red,
                                           const T* __restrict__ alpha,
                                           int n, int p) {
  constexpr int LS = ls_stride<T>(NB);
  constexpr int TQ = Tile<NB, NTH>::TQ;
  constexpr int RT = Tile<NB, NTH>::RT;
  constexpr int WG = Tile<NB, NTH>::WG;
  constexpr int H = Tile<NB, NTH>::H;
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

// Sum the SLOTS partials red[w][c][q] (each [p + 1][TQ]) of each query of
// the TQ-query tile starting at q0 and store output `out` of n_out:
// mean_out[(q * n_out + out) * p + c] and var_out[q * n_out + out],
// consecutive threads on consecutive queries.
template <typename T, int TQ, int SLOTS, int NTH>
__device__ __forceinline__ void store_slots(const T* red, int64_t q0,
                                            int64_t n_q, int p, int n_out,
                                            int out, T* __restrict__ mean_out,
                                            T* __restrict__ var_out) {
  for (int idx = threadIdx.x; idx < TQ * (p + 1); idx += NTH) {
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

// store_slots for a tiled block at bucket NB.
template <typename T, int NB, int NTH = NT>
__device__ __forceinline__ void store_tile(const T* red, int64_t q0,
                                           int64_t n_q, int p, int n_out,
                                           int out, T* __restrict__ mean_out,
                                           T* __restrict__ var_out) {
  store_slots<T, Tile<NB, NTH>::TQ, Tile<NB, NTH>::SLOTS, NTH>(
      red, q0, n_q, p, n_out, out, mean_out, var_out);
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

// Blocks of a persistent grid of `threads`-thread blocks: one per resident
// slot on every SM, at most one per query tile. A launch whose (device,
// size) is cached makes no CUDA call but cudaGetDevice.
template <class Kernel>
inline cudaError_t persistent_grid(GridCache& cache, Kernel kernel,
                                   size_t smem, int64_t n_q, int tq,
                                   int* grid, int threads = NT) {
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
                                                          threads, smem);
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
// Panel body: N_TILED_MAX < n <= Panel<T>::N_MAX (kernels 2 and 3)
// ---------------------------------------------------------------------------
// Shape of a panel block of NT threads. A warp is WR x WC lanes, each
// thread a TM x TN tile of A (its TN queries in groups of 4, 4 * WC
// apart), so a warp owns WTM rows by WTN queries; QG warps span the TQ
// queries of a tile and RTP warps the PROWS rows of a row panel. chol_inv
// streams through NSLOT slots of PROWS x JC values (JC: 256 bytes of a row
// in float32, 128 in float64), row stride LSTR (JC plus 16 bytes: rows
// start 16-byte aligned). The K tile and the staged rows of x are sized
// by n rounded up to ROUND, so few sizes reach the launch cache. N_MAX is
// the largest count it takes: a float32 block at n = 512, d = 16, p = 8
// needs 209,920 B (one block, 8 warps an SM; two up to n = 256 at
// d = 3), a float64 block at n = 256 202,752 B.
template <typename T>
struct Panel {
  // The register tile: lane row lr holds rows lr * TM .. lr * TM + TM - 1
  // of its warp's WTM.
  static constexpr int TM = 4;
  static constexpr int TN = 4;
  static constexpr int WTM = WR * TM;
  static constexpr int WTN = WC * TN;
  static constexpr int TQ = 64;
  static_assert(TN % 4 == 0 && TQ % WTN == 0, "query tiling");
  static constexpr int QG = TQ / WTN;
  static constexpr int RTP = NW / QG;
  static constexpr int PROWS = RTP * WTM;
  static constexpr int JC = (sizeof(T) == 4 ? 256 : 128) / (int)sizeof(T);
  static constexpr int LSTR = JC + 16 / (int)sizeof(T);
  static constexpr int NSLOT = 2;
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 2 : 1;
  static constexpr int ROUND = 64;
  static constexpr int N_MAX = sizeof(T) == 4 ? 512 : 256;
  static_assert((PROWS * JC) % NT == 0, "copies per thread");
};

template <typename T>
__host__ __device__ constexpr int panel_rows(int n) {
  return (n + Panel<T>::ROUND - 1) / Panel<T>::ROUND * Panel<T>::ROUND;
}

// Dynamic shared memory of one panel block: the [rows][TQ] K tile, the
// NSLOT chol_inv slots, the [RTP][p + 1][TQ] partial sums and the staged
// rows of x ([rows][d]) and of the mask.
template <typename T>
__host__ __device__ constexpr size_t panel_smem_bytes(int n, int p, int d) {
  using P = Panel<T>;
  return sizeof(T) *
         ((size_t)panel_rows<T>(n) * (P::TQ + d + 1) +
          (size_t)P::NSLOT * P::PROWS * P::LSTR +
          (size_t)P::RTP * (p + 1) * P::TQ);
}

// Pointers into a panel block's shared memory (see panel_smem_bytes).
template <typename T>
struct PanelSmem {
  T *ks, *ring, *red, *xs, *ms;
  __device__ __forceinline__ PanelSmem(unsigned char* raw, int n, int p,
                                       int d) {
    using P = Panel<T>;
    const int rows = panel_rows<T>(n);
    ks = reinterpret_cast<T*>(raw);
    ring = ks + rows * P::TQ;
    red = ring + P::NSLOT * P::PROWS * P::LSTR;
    xs = red + P::RTP * (p + 1) * P::TQ;
    ms = xs + rows * d;
  }
};

// One element of an asynchronous copy to shared memory; src_bytes == 0
// writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Walks the chol_inv tiles of one output in order: row panels of PROWS rows
// below the count, and in each the column chunks of JC up to the panel's
// last row (or the count).
template <typename T>
struct PanelCursor {
  int n, pi = 0, ci = 0, nc = 0;
  __device__ __forceinline__ explicit PanelCursor(int n_) : n(n_) {
    nc = chunks();
  }
  __device__ __forceinline__ int r0() const { return pi * Panel<T>::PROWS; }
  __device__ __forceinline__ int jc0() const { return ci * Panel<T>::JC; }
  __device__ __forceinline__ bool valid() const { return r0() < n; }
  __device__ __forceinline__ bool last_chunk() const { return ci == nc - 1; }
  __device__ __forceinline__ int chunks() const {
    const int end = min(n, r0() + Panel<T>::PROWS);
    return r0() < n ? (end + Panel<T>::JC - 1) / Panel<T>::JC : 0;
  }
  __device__ __forceinline__ void next() {
    if (++ci == nc) {
      ++pi;
      ci = 0;
      nc = chunks();
    }
  }
};

// Start copying the cursor's tile of chol_inv (row stride cap) into a
// slot; elements above the diagonal or at or past the count are
// zero-filled without a read. Every thread of the block copies its share.
template <typename T>
__device__ __forceinline__ void panel_fetch(T* slot,
                                            const T* __restrict__ chol_inv,
                                            int cap,
                                            const PanelCursor<T>& cur) {
  using P = Panel<T>;
  const int r0 = cur.r0(), jc0 = cur.jc0(), n = cur.n;
  // Thread t copies column t % JC of rows t / JC + i * NT / JC.
  const int c = threadIdx.x % P::JC, col = jc0 + c;
#pragma unroll
  for (int i = 0; i < P::PROWS * P::JC / NT; ++i) {
    const int r = threadIdx.x / P::JC + i * (NT / P::JC);
    const int row = r0 + r;
    const bool in = row < n && col <= row;
    cp_async<sizeof(T)>(slot + r * P::LSTR + c,
                        in ? chol_inv + (int64_t)row * cap + col : chol_inv,
                        in ? (int)sizeof(T) : 0);
  }
}

// ks[j][ql] = kfn(j) for j < n and 0 for n <= j < n rounded up to 4 (the
// solve's j loop runs in steps of 4), where ql is this thread's query in
// the TQ-query tile (threadIdx.x % TQ).
template <typename T, int TQ, class KFn>
__device__ __forceinline__ void fill_k_rows(T* ks, const KFn& kfn, int n) {
  constexpr int JS = NT / TQ;  // threads per query
  const int ql = threadIdx.x % TQ;
  const int j0 = threadIdx.x / TQ;
  // Unrolled so that several rows' covariances are in flight at once.
#pragma unroll 4
  for (int j = j0; j < n; j += JS) ks[j * TQ + ql] = kfn(j);
  for (int j = n + j0; j < (n + 3) / 4 * 4; j += JS) ks[j * TQ + ql] = T(0);
}

// acc += L^-1[rows, jc0 : jc0 + jn] K[jc0 : jc0 + jn, queries] for this
// thread's TM rows (lp: its first row in the slot, the next rows
// on) and TN queries (kp: the K tile at row jc0, its first query), j
// ascending, four j at a time. The values past jn up to the next multiple
// of 4 are zeros in the slot.
template <typename T>
__device__ __forceinline__ void panel_chunk(
    T (&acc)[Panel<T>::TM][Panel<T>::TN], const T* lp, const T* kp,
    int jn) {
  using P = Panel<T>;
  constexpr int TM = P::TM, TN = P::TN;
#pragma unroll 2
  for (int j = 0; j < jn; j += 4) {
    T l[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      load_vec(l[r], lp + r * P::LSTR + j);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      T k[TN / 4][4];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        load_vec(k[g], kp + (j + jj) * P::TQ + g * 4 * WC);
      }
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] += l[r][jj] * k[c / 4][c % 4];
      }
    }
  }
}

// part[c] summed over the WR row lanes; the lanes of row lane 0 store it
// to (first) or add it to dst at their query c.
template <typename T>
__device__ __forceinline__ void panel_add(T (&part)[Panel<T>::TN], T* dst,
                                          int lr, bool first) {
#pragma unroll
  for (int off = WC; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < Panel<T>::TN; ++c) {
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
    }
  }
  if (lr == 0) {
#pragma unroll
    for (int c = 0; c < Panel<T>::TN; ++c) {
      T* q = dst + (c / 4) * 4 * WC + c % 4;
      *q = first ? part[c] : *q + part[c];
    }
  }
}

// The end of a row panel: this thread's rows (row0 + r, r < TM) into
// alpha^T A and sum A^2, one column at a time, over the row lanes, then
// stored (first panel) or added to the warp's partial sums red[c][q]
// (c < p: mean, c == p: var). Rows at or past n hold exact zeros. Clears
// acc.
template <typename T>
__device__ __forceinline__ void panel_reduce(
    T (&acc)[Panel<T>::TM][Panel<T>::TN], T* red,
    const T* __restrict__ alpha, int row0, int n, int p, int lr,
    bool first) {
  constexpr int TM = Panel<T>::TM, TN = Panel<T>::TN, TQ = Panel<T>::TQ;
  T part[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    part[c] = T(0);
#pragma unroll
    for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * acc[r][c];
  }
  panel_add(part, red + p * TQ, lr, first);
#pragma unroll 1
  for (int o = 0; o < p; ++o) {
    T a[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = row0 + r;
      a[r] = row < n ? __ldg(alpha + (int64_t)row * p + o) : T(0);
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      part[c] = T(0);
#pragma unroll
      for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * a[r];
    }
    panel_add(part, red + o * TQ, lr, first);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = T(0);
  }
}

// A = L^-1 K for one query tile and output, row panel by row panel, and
// its reductions into red: chol_inv streams through the ring of NSLOT
// slots by cp.async, NSLOT - 1 tiles ahead of the solve, one barrier a
// tile. `ic` has already started (and committed, one group each) the first
// NSLOT - 1 tiles into slots 0 .. NSLOT - 2; the K tile is in ks. A warp
// owns WTM rows of each panel (row tile rt) and WTN queries (qbase, with
// its lane's offset); its j loop stops at min(n, its last row + 1).
// Every thread of the block must call this.
template <typename T>
__device__ __forceinline__ void solve_panels(
    const PanelSmem<T>& sm, PanelCursor<T>& ic,
    const T* __restrict__ chol_inv, const T* __restrict__ alpha, int cap,
    int n, int p, int rt, int lr, int qbase) {
  using P = Panel<T>;
  constexpr int SLOT = P::PROWS * P::LSTR;
  T acc[P::TM][P::TN];
#pragma unroll
  for (int r = 0; r < P::TM; ++r) {
#pragma unroll
    for (int c = 0; c < P::TN; ++c) acc[r][c] = T(0);
  }
  T* red = sm.red + rt * (p + 1) * P::TQ + qbase;
  PanelCursor<T> cc(n);
  for (int t = 0; cc.valid(); ++t) {
    cp_async_wait<P::NSLOT - 2>();  // tile t has landed (this thread's part)
    __syncthreads();  // ... every thread's; the slot of tile t - 1 is free
    if (ic.valid()) {
      panel_fetch(sm.ring + (t + P::NSLOT - 1) % P::NSLOT * SLOT, chol_inv,
                  cap, ic);
      ic.next();
    }
    cp_async_commit();  // one group a tile, empty past the last
    const int wr0 = cc.r0() + rt * P::WTM;
    const int jn = min(P::JC, min(n, wr0 + P::WTM) - cc.jc0());
    if (jn > 0) {
      panel_chunk(acc,
                  sm.ring + t % P::NSLOT * SLOT +
                      (rt * P::WTM + lr * P::TM) * P::LSTR,
                  sm.ks + cc.jc0() * P::TQ + qbase, jn);
    }
    if (cc.last_chunk()) {
      panel_reduce(acc, red, alpha, wr0 + lr * P::TM, n, p, lr,
                   cc.pi == 0);
    }
    cc.next();
  }
}

// ---------------------------------------------------------------------------
// Streamed body: kernel 1 above N_TILED_MAX, kernels 2 and 3 above
// Panel<T>::N_MAX
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
