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
// In float64 (the rigor paths: the extended and hybrid checks) the product
// L^-1 K runs on the FP64 tensor cores (DMMA, mma.sync m16n8k16, 67
// TFLOP/s, twice the CUDA cores' FP64 rate) in the tiled and panel bodies
// (the DMMA bodies below). What bounds it then is the k fill on the CUDA
// cores: a float64 exp or sqrt is tens of FP64 instructions, so at the
// adaptive example's n = 181 the 362 evaluations a query cost about as
// much time as its 2 x 19,968 product FMAs on DMMA (16-row tiles, k steps
// of 16); next come the shared-memory loads that feed the mma fragments
// (0.5 to 0.75 bytes an FMA) and, where chol_inv is streamed, its reads
// from L2.
//
// Three bodies, chosen by shape alone (count, dtype, p, d), for kernels 1,
// 2 and 3 alike: the tiled body up to N_TILED_MAX = 128 rows, the panel
// body above it up to panel_max<T>() (512 rows in float32, 256 in
// float64), and the strip body above that, up to the 2,048 rows the GPs
// route to a kernel (kernel_max_capacity). A fourth, the streamed body,
// runs only on kernels 4-7 above 128 rows and behind the comparison
// entries of kernels 1-3.
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
// The panel body (128 < n <= panel_max<T>(), or a tiled block that does
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
//      slots of PROWS x JC values (a 64-row panel, 256 bytes of columns)
//      filled by cp.async, the next tile in flight while the block solves
//      this one (64 j steps), one barrier a tile. Tiles past the
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
// The strip body (panel_max<T>() < n; Strip, solve_strips and the kernel
// gp_program_strip of gp_predict_program.cuh, which kernel 1 reaches
// through a one-output stationary program). Above the panel K[0:n, 64
// queries] no longer fits a block (256 KB in float32 at n = 1,021, 512 KB
// in float64, against 227 KB), nor do an item's accumulators. So a
// thread-block cluster of 2 blocks takes each item, and the rows of A go
// to its blocks by 64-row panels, 4 a block, in rounds of 8 panels (512
// rows; the first round takes the rest), dealt from n alone longest first
// onto the less loaded block (strip_deal). What bounds it on the H100:
// per query and output n (n + 1) / 2 product FMAs (FP32 on the CUDA
// cores, 67 TFLOP/s; float64 on DMMA, 67 TFLOP/s) against n covariances
// and 28 bytes, so arithmetic fed from shared memory, as in the panel
// body. What it does about the four causes that held the strip body's
// first design (one block an item walking 256-row strips) to 31 %
// (float32) and 22 % (float64) of its bound:
//   1. K evaluated again for every strip (2.5 n covariances a query and
//      output at n = 1,021, 4.5 n at 2,048): the blocks of a cluster walk
//      the same 32-column chunks in the same order; each evaluates half
//      of a chunk's K rows and stores them into both blocks' K buffers
//      through distributed shared memory, so K is evaluated once a round
//      (1.5 n at 1,021, 2.5 n at 2,048). Once an item (a cluster of
//      ceil(n / 256) blocks, one round) was slower: a round's walk runs to
//      its last row, and the warps of its lower panels idle once the walk
//      passes them (by count, 53 % of a block's warp-chunks busy at 1,021
//      in one round, 71 % in two);
//   2. small launches idled the card (a sampler step of 64 items on 64
//      blocks, each a serial chain of 80 chunks): an item is 2 blocks,
//      each walking 48 chunks at 1,021, on a persistent grid of clusters
//      (cudaOccupancyMaxActiveClusters; a cluster that does not fit is
//      refused, never run another way);
//   3. float64 met all 512 threads at a barrier after each DMMA k step:
//      a chunk is two k steps, and no block-wide barrier is left in the
//      walk (a warp copies its own rows of chol_inv and waits for them
//      with __syncwarp). Shared memory at p = 8, float64: the ring 2 x 32
//      x 264 x 8 = 135,168 B, the K buffers 3 x 32 x 72 x 8 = 55,296, the
//      partial sums 4 x 9 x 64 x 8 = 18,432 (one slot a panel, its 4
//      warps adding in turns: 73,728 with one a warp), the queries 8,704
//      (float32: 114,176 B, two blocks an SM);
//   4. the fill and the solve overlapped in part: the next chunk's K and
//      chol_inv are in flight while a warp solves this chunk, and the
//      cluster barrier is split (arrive after the fill, wait before the
//      next chunk), so a block waits only for the other's fill.
// The partial sums: each warp (float32) or panel slot (float64) reduces
// its rows into its own slot after a round, and the cluster sums every
// block's slots through distributed shared memory in block-rank, then slot
// order (strip_store): the order of every sum is fixed by n, and a query's
// outputs are the same wherever it lies in a launch and whatever Q is.
// chol_inv's rows are cap values apart (not 16 bytes for an odd cap), so
// its copies stay element-wise cp.async, as in the panel body; TMA is not
// used. On the card (H100 80GB HBM3, 700.00 W; benchmarks/strip_parts.py,
// CUDA-graph ms, the first design in turns in the same call): the
// refinement chunk at 1,021 rows 97.97 ms in float32 (107.66), 119.60 in
// float64 (151.30); the sampler step 0.305 / 0.251 (0.599 / 0.618);
// kernel 1 at 2,048 rows 171.85 / 209.94 (201.77 / 297.76). At the chunk,
// float32 / float64: the fill, copies and exchange alone 45.11 / 83.90,
// the solve alone 83.49 / 96.44, the exchange alone 15.22 / 29.89; the
// fill after the solve 1.108 / 1.174x. In other calls: the fill left to
// the warps with no rows in the chunk 1.07 / 1.32x (they became the
// critical path); clusters of 1, 4 and 8 blocks 0.986 / 1.079, 1.193 /
// 1.194 and 1.851 / 1.993x of 2 at the chunk and 2.00 / 2.08, 1.30 / 1.59
// and 1.57 / 2.18x at the sampler step; the cluster barrier whole rather
// than split 1.07-1.21x (at 4 blocks).
//
// The streamed body (solve_streamed; kernels 4-7 above 128 rows, and the
// comparison entries gp_predict_streamed_* and gp_program_streamed_* of
// kernels 1-3 at any count): one query per thread, the chol_inv row tile
// staged transposed, and k recomputed in chunks of CB columns, so any
// count up to kernel_max_capacity = 2048 runs in a fixed amount of shared
// memory.
//
// The DMMA bodies (float64 kernels 1-3; dmma, solve_tile_dmma,
// dmma_tiles, solve_panels_dmma, strip_chunk_dmma). The float32 bodies
// above, kernels 4 and 5 in both dtypes and kernels 6 and 7 in float64
// keep the CUDA-core solve; so does the float64 streamed body. (Kernels 6 and 7's float32
// tiled bodies run on the TF32 tensor cores, off every path:
// gp_predict_variants.cu.)
//   - A = L^-1 K in 16 x 8 x 16 mma tiles (m16n8k16, the fastest depth on
//     the card): a warp owns 16-row tiles of A (rows on the mma's M,
//     queries on N, j on K). A k step loads one A fragment (16 rows x 16 j
//     of chol_inv) and one B fragment per 8 queries from shared memory;
//     both arrays are swizzled (swz) rather than padded, so every fragment
//     load is two 128-byte wavefronts;
//   - the tiled body keeps Tile's warp pairs (row tiles g and RT-1-g, the
//     same work for every warp) and stages chol_inv packed by row tile,
//     only the columns up to each tile's last row (dmma_tri: 72 KB at
//     NB = 128 against 128 KB square, 160 KB at 192);
//   - overlap of the k fill with the product (TileD, dmma_tiles): up to
//     bucket 128 two blocks share an SM (111 KB each at the bench's
//     shape, a 32-query K tile at 128), each filling then solving, so one
//     block's fill runs beside the other's solve. Bucket 192 serves
//     kernels 2 and 3 from 129 to 192 rows (the adaptive example's 181)
//     with chol_inv resident (160 KB), which leaves room for one block:
//     it is warp-specialised, 6 mma warps solving one 16-query tile from
//     one K buffer while 10 fill warps evaluate the next tile into the
//     other, one barrier a tile. Streaming chol_inv from L2 for every
//     query tile instead cost more than the product (PERF.md);
//   - the k loop is not unrolled: at the 128 registers that two blocks
//     (or 16 warps) an SM allow, unrolling it spilled and ran 8-10 %
//     slower;
//   - above 192 rows, or where that block does not fit, the panel body
//     gives each warp whole 16-row tiles for the TQ = 64 queries of an
//     item, longest first onto the least loaded warp (lpt_tiles, from n
//     alone), and each warp streams its tiles' chol_inv through its own
//     cp.async ring of 16 x 16 slots, synchronised by __syncwarp alone;
//   - the triangular skip stops a tile's k loop at min(n, its last row +
//     1) rounded up to 16: K rows and chol_inv columns from n to there are
//     zero-filled, so the last step adds exact zeros;
//   - epilogue from fragments: each lane squares or weights its
//     accumulators, sums its rows, and reduce_tiles sums the 8 lanes of a
//     query column by halving exchanges into the same partial-sum slots
//     as the CUDA-core bodies.
// Every query sees the same operations wherever it lies in a launch: the
// k loop starts at j = 0 in the same steps for every query, and each
// query's sums run the same tree. So a query's outputs are bit for bit
// the same in any launch, which the hybrid sweep (equal to the extended
// one) and the sharded sweeps rely on.
//
// Precision: FP32 FMAs on the CUDA cores in float32; in float64 FP64 FMAs
// on the CUDA cores for k and the reductions and IEEE float64 mma on the
// tensor cores for the product, whose summation order within an mma is the
// hardware's; no fast-math, library expf/exp. The CUDA-core bodies keep
// A's ascending-j order; the reductions' order differs from the plain
// twin's; both stay inside the computed bounds (rounding_bounds, the
// float64 margins' U_EFF model, chip_smoke.py).

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>
#include <type_traits>

namespace gp_common {

namespace cg = cooperative_groups;

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
template <int NB>
__host__ __device__ constexpr size_t dmma_tiled_smem_bytes(int n_res, int p,
                                                           int d);

template <typename T, int NB>
__host__ __device__ constexpr size_t tiled_smem_bytes(int n_res, int p,
                                                      int d) {
  // Float64 runs the DMMA body and its layout.
  if constexpr (sizeof(T) == 8) {
    return dmma_tiled_smem_bytes<NB>(n_res, p, d);
  } else {
    return sizeof(T) *
           ((size_t)n_res * NB * ls_stride<T>(NB) +
            (size_t)NB * Tile<NB>::TQ +
            (size_t)Tile<NB>::SLOTS * (p + 1) * Tile<NB>::TQ +
            (size_t)NB * (d + 1));
  }
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
template <typename T, int NTH = NT>
__device__ __forceinline__ void stage_rows(T* xs, T* ms,
                                           const T* __restrict__ x,
                                           const T* __restrict__ mask, int n,
                                           int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += NTH) xs[idx] = x[idx];
  for (int j = threadIdx.x; j < n; j += NTH) ms[j] = mask[j];
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
// consecutive threads on consecutive queries. `tid` is the thread's index
// among the NTH that store (threadIdx.x where they are the block's first).
template <typename T, int TQ, int SLOTS, int NTH>
__device__ __forceinline__ void store_slots(const T* red, int64_t q0,
                                            int64_t n_q, int p, int n_out,
                                            int out, T* __restrict__ mean_out,
                                            T* __restrict__ var_out,
                                            int tid) {
  for (int idx = tid; idx < TQ * (p + 1); idx += NTH) {
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
      red, q0, n_q, p, n_out, out, mean_out, var_out, (int)threadIdx.x);
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
// Float64 on the FP64 tensor cores (DMMA): the tiled and panel bodies of
// kernels 1-3 in float64 (their design is in the header note)
// ---------------------------------------------------------------------------
// Depth of one mma.sync: m16n8k16 in float64 (sm_90), the fastest of the
// three float64 depths in the first builds on the card.
constexpr int KD = 16;
constexpr int KS4 = KD / 4;  // groups of 4 columns of one mma

// c += A B for one 16 x 8 x 16 float64 tile. Fragments of lane (g, t) =
// (lane / 4, lane % 4): a[s][h] = A[g + 8h][4s + t], b[s] = B[4s + t][g],
// c[2h + e] = C[g + 8h][2t + e] (the PTX ISA's layout of this shape).
__device__ __forceinline__ void dmma(double (&c)[4],
                                     const double (&a)[KS4][2],
                                     const double (&b)[KS4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0][0]), "d"(a[0][1]), "d"(a[1][0]), "d"(a[1][1]),
        "d"(a[2][0]), "d"(a[2][1]), "d"(a[3][0]), "d"(a[3][1]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// n rounded up to the mma depth: K rows and chol_inv columns from n to
// there are zeros, so the last k step adds exact zeros.
__host__ __device__ constexpr int dmma_rows(int n) {
  return (n + KD - 1) / KD * KD;
}

// Column of element (row, col) in a [rows][W] shared-memory array whose
// width W is a multiple of 16 doubles, swizzled so that a fragment load
// (4 consecutive rows by 4 columns a half-warp, or 4 rows by 4 column
// groups) meets 16 different 8-byte banks: two 128-byte wavefronts a
// warp, no padding.
__device__ __forceinline__ int swz(int row, int col) {
  return col ^ ((row & 3) << 2);
}

// v[c] is this lane's partial for query tile c of the warp's N (query
// 8c + 2t + e, for one e); returns the sum over the 8 lanes g of this t
// for query tile c = g >> (3 - log2 N), alike in every lane that shares
// it. Halving exchanges over g's bits from the top, then butterflies:
// every query's sum has the same tree over the g lanes,
// ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7)), whatever its tile.
template <int N, int OFF = 16, typename T>
__device__ __forceinline__ T reduce_tiles(const T (&v)[N], int lane) {
  if constexpr (OFF == 2) {
    return v[0];
  } else if constexpr (N == 1) {
    const T w[1] = {v[0] + __shfl_xor_sync(0xffffffffu, v[0], OFF)};
    return reduce_tiles<1, OFF / 2>(w, lane);
  } else {
    const bool hi = lane & OFF;
    T w[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const T send = hi ? v[k] : v[k + N / 2];
      w[k] = (hi ? v[k + N / 2] : v[k]) +
             __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    return reduce_tiles<N / 2, OFF / 2>(w, lane);
  }
}

// log2 of the g lanes that share a reduce_tiles result over N tiles.
template <int N>
__host__ __device__ constexpr int share_bits() {
  return N == 2 ? 2 : N == 4 ? 1 : 0;
}

// Shape of the float64 tiled body at bucket NB: RT row tiles of 16 rows;
// WG warps share a query group, each taking the row tiles g and RT-1-g
// (H of them); an mma warp owns QT query tiles of 8; TQ queries a block
// tile; one partial-sum slot a row warp. Up to bucket 128 all NW warps
// fill and then solve, two blocks an SM. Warp-specialised (SPEC; bucket
// 192, where kernels 2 and 3 keep chol_inv resident from 129 to 192 rows,
// 160 KB): MW mma warps solve one tile from one K buffer while FW fill
// warps evaluate the next tile's K into the other, one barrier a tile
// (dmma_tiles), so the float64 k fill on the CUDA cores overlaps the
// product on the tensor cores.
template <int NB>
struct TileD {
  static_assert(NB % 16 == 0 && NB <= 192, "bucket");
  static constexpr int RT = NB / 16;
  static constexpr int WG = RT > 1 ? RT / 2 : 1;
  static constexpr int H = RT > 1 ? 2 : 1;
  static constexpr bool SPEC = NB == 192;
  static_assert(SPEC || NB <= N_TILED_MAX, "bucket 192 is warp-specialised");
  static constexpr int QT = NB >= 128 ? 2 : 4;
  static constexpr int MW = SPEC ? 6 : NW;
  static constexpr int FW = SPEC ? 10 : 0;
  static constexpr int NTH = 32 * (MW + FW);
  static constexpr int FTH = SPEC ? 32 * FW : NTH;  // threads that fill
  static constexpr int TQ = MW / WG * 8 * QT;
  static constexpr int NBUF = SPEC ? 2 : 1;
};

// The query tile and the threads of a tiled block in dtype T.
template <typename T, int NB>
__host__ __device__ constexpr int tiled_tq() {
  if constexpr (sizeof(T) == 4) {
    return Tile<NB>::TQ;
  } else {
    return TileD<NB>::TQ;
  }
}
template <typename T, int NB>
__host__ __device__ constexpr int tiled_threads() {
  if constexpr (sizeof(T) == 4) {
    return NT;
  } else {
    return TileD<NB>::NTH;
  }
}

// The resident chol_inv of the tiled body, transposed and packed: row
// tile m (rows 16m .. 16m + 15) keeps its columns j < 16 (m + 1) as a
// [j][16] block at dmma_tri(m), swizzled. Columns past a row tile's last
// row are never read, so the triangle takes 128 RT (RT + 1) values, not
// NB^2 (72 KB at NB = 128 against 128 KB).
__host__ __device__ constexpr int dmma_tri(int m) {
  return 128 * m * (m + 1);
}

// Blocks of a tiled kernel per SM for its launch bounds: the float32
// choice (tiled_min_blocks); in float64 one warp-specialised block, or
// two blocks so that one block's k fill overlaps the other's solve.
template <typename T, int NB>
__host__ __device__ constexpr int tiled_blocks() {
  if constexpr (sizeof(T) == 4) {
    return tiled_min_blocks<T, NB>();
  } else {
    return TileD<NB>::SPEC ? 1 : 2;
  }
}

// Dynamic shared memory of one float64 tiled block: the packed chol_inv
// of n_res outputs, NBUF [NB][TQ] K tiles and [WG][p + 1][TQ] partial
// sums, and the active rows of x and of the mask.
template <int NB>
__host__ __device__ constexpr size_t dmma_tiled_smem_bytes(int n_res, int p,
                                                           int d) {
  using TL = TileD<NB>;
  return sizeof(double) *
         ((size_t)n_res * dmma_tri(NB / 16) +
          (size_t)TL::NBUF * (NB + TL::WG * (p + 1)) * TL::TQ +
          (size_t)NB * (d + 1));
}

// Pointers into a float64 tiled block's shared memory; ks(b) and red(b)
// are buffer b's K tile and partial sums.
template <int NB>
struct TiledSmemD {
  using TL = TileD<NB>;
  double *ls, *kbuf, *rbuf, *xs, *ms;
  int rsz;
  __device__ __forceinline__ TiledSmemD(unsigned char* raw, int n_res, int p,
                                        int d)
      : ls(reinterpret_cast<double*>(raw)),
        kbuf(ls + n_res * dmma_tri(NB / 16)),
        rbuf(kbuf + TL::NBUF * NB * TL::TQ),
        xs(rbuf + TL::NBUF * TL::WG * (p + 1) * TL::TQ),
        ms(xs + NB * d),
        rsz(TL::WG * (p + 1) * TL::TQ) {}
  __device__ __forceinline__ double* ks(int b) const {
    return kbuf + b * NB * TL::TQ;
  }
  __device__ __forceinline__ double* red(int b) const {
    return rbuf + b * rsz;
  }
};

// Stage chol_inv[:n, :n] (row stride cap) into the packed layout of
// dmma_tri, by NTH threads; zero past the count. Row tiles at or past n
// are never read.
template <int NB, int NTH>
__device__ __forceinline__ void stage_chol_inv_dmma(
    double* ls, const double* __restrict__ chol_inv, int cap, int n) {
#pragma unroll 1
  for (int m = 0; m < NB / 16 && 16 * m < n; ++m) {
    const int cols = 16 * (m + 1);
    double* dst = ls + dmma_tri(m);
    for (int idx = threadIdx.x; idx < 16 * cols; idx += NTH) {
      const int il = idx / cols;
      const int j = idx - il * cols;
      const int i = 16 * m + il;
      dst[j * 16 + swz(j, il)] =
          i < n && j < n ? chol_inv[(int64_t)i * cap + j] : 0.0;
    }
  }
}

// ks[j][swz(j, ql)] = kfn(j) for j < n and 0 up to dmma_rows(n), where ql
// is the query in the TQ-query tile of fill thread tid (of NTH).
template <int TQ, int NTH, class KFn>
__device__ __forceinline__ void fill_k_dmma(double* ks, const KFn& kfn,
                                            int n, int tid) {
  constexpr int JS = NTH / TQ;  // threads per query
  static_assert(NTH % TQ == 0, "whole queries a fill");
  const int ql = tid % TQ;
  const int j0 = tid / TQ;
  // Unrolled so that several rows' covariances are in flight at once.
#pragma unroll 4
  for (int j = j0; j < n; j += JS) {
    ks[j * TQ + swz(j, ql)] = kfn(j);
  }
  for (int j = n + j0; j < dmma_rows(n); j += JS) {
    ks[j * TQ + swz(j, ql)] = 0.0;
  }
}

// This thread's place in a tiled block's K fill: (its thread index among
// the threads that fill, its query in the tile). Warp-specialised, the
// fill warps are the warps after the MW mma warps.
template <int NB>
__device__ __forceinline__ int fill_tid() {
  using TL = TileD<NB>;
  return (int)threadIdx.x - (TL::SPEC ? 32 * TL::MW : 0);
}

// A tiled block's K fill of one item by its fill threads (fill_tid).
template <int NB, class KFn>
__device__ __forceinline__ void fill_tile_dmma(double* ks, const KFn& kfn,
                                               int n) {
  using TL = TileD<NB>;
  fill_k_dmma<TL::TQ, TL::FTH>(ks, kfn, n, fill_tid<NB>());
}

// A float64 tiled block's items u = 0 .. items - 1 (its query tiles, in
// order): fill(u, b) evaluates item u's K into buffer b by the fill
// threads (fill_tile_dmma), solve(u, b) runs the mma warps' product and
// epilogue into red(b), store(u, b) stores red(b) by every thread.
// Warp-specialised (SPEC), the fill warps fill item u + 1 while the mma
// warps solve item u, one barrier an item; else fill, barrier, solve,
// barrier, store.
template <int NB, class Fill, class Solve, class Store>
__device__ __forceinline__ void dmma_tiles(int64_t items, const Fill& fill,
                                           const Solve& solve,
                                           const Store& store) {
  using TL = TileD<NB>;
  if constexpr (TL::SPEC) {
    const bool mma = (int)(threadIdx.x >> 5) < TL::MW;
    if (!mma && items > 0) fill(0, 0);
    __syncthreads();  // item 0's K filled
    for (int64_t u = 0; u < items; ++u) {
      const int b = (int)(u & 1);
      if (mma) {
        solve(u, b);
      } else if (u + 1 < items) {
        fill(u + 1, b ^ 1);
      }
      __syncthreads();  // red(b) written, K(b ^ 1) filled, K(b) free
      store(u, b);
    }
  } else {
    for (int64_t u = 0; u < items; ++u) {
      fill(u, 0);
      __syncthreads();  // k staged
      solve(u, 0);
      __syncthreads();  // partials written; k may be overwritten
      store(u, 0);
    }
  }
}

// The tiles of n_tiles that block blockIdx.x of a persistent grid takes:
// blockIdx.x, + gridDim.x, ...
__device__ __forceinline__ int64_t block_items(int64_t n_tiles) {
  return n_tiles > blockIdx.x
             ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
             : 0;
}

// The float64 tiled body's A = L^-1 K on DMMA. Warp (grp, wg) owns the
// query columns grp * 8 QT .. (QT tiles of 8) and the row tiles wg and
// RT - 1 - wg (16 rows each, H of them), so every warp of a full bucket
// does the same work; its k loop runs both tiles to the shorter one's end
// min(n, 16 wg + 16) rounded to KD, then the longer one alone. Per k step
// a warp loads 2 A and QT B fragments for 2 QT mma. The epilogue squares
// or weights each accumulator, sums the thread's rows and reduces over
// the g lanes (reduce_tiles) into red[wg][c][q] (c < p: mean, c == p:
// var). Rows at or past n hold exact zeros.
template <int NB>
__device__ __forceinline__ void solve_tile_dmma(
    const double* ks, const double* ls, double* red,
    const double* __restrict__ alpha, int n, int p) {
  using TL = TileD<NB>;
  constexpr int TQ = TL::TQ, RT = TL::RT, WG = TL::WG, H = TL::H;
  constexpr int QT = TL::QT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / WG;
  const int wg = warp - grp * WG;
  const int qcol = grp * 8 * QT;
  const int n4 = dmma_rows(n);
  int mt[H], jend[H];
  mt[0] = wg;
  if constexpr (H == 2) mt[1] = RT - 1 - wg;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    jend[h] = 16 * mt[h] < n ? min(n4, 16 * mt[h] + 16) : 0;
  }
  double acc[H][QT][4];
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int c = 0; c < QT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][c][e] = 0.0;
    }
  }
  // Lane (g, t) reads K[j0 + 4s + t][qcol + 8c + g] and
  // L[16 mt + g + 8hh][j0 + 4s + t]; (j0 + 4s + t) & 3 == t.
  const double* kp = ks + t * TQ;
  int kcol[QT];
#pragma unroll
  for (int c = 0; c < QT; ++c) kcol[c] = swz(t, qcol + 8 * c + g);
  const double* lp[H];
#pragma unroll
  for (int h = 0; h < H; ++h) lp[h] = ls + dmma_tri(mt[h]) + t * 16;
  const int acol0 = swz(t, g), acol1 = swz(t, g + 8);

  // Both tiles up to the shorter extent, then the longer one alone (a
  // tile at or past n has extent 0 and was not staged).
  auto step = [&](int j0, int only) {
    double b[QT][KS4];
#pragma unroll
    for (int c = 0; c < QT; ++c) {
#pragma unroll
      for (int s = 0; s < KS4; ++s) b[c][s] = kp[(j0 + 4 * s) * TQ + kcol[c]];
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (only >= 0 && h != only) continue;
      double a[KS4][2];
#pragma unroll
      for (int s = 0; s < KS4; ++s) {
        a[s][0] = lp[h][(j0 + 4 * s) * 16 + acol0];
        a[s][1] = lp[h][(j0 + 4 * s) * 16 + acol1];
      }
#pragma unroll
      for (int c = 0; c < QT; ++c) dmma(acc[h][c], a, b[c]);
    }
  };
  const int j_both = min(jend[0], jend[H - 1]);
  const int j_all = max(jend[0], jend[H - 1]);
  const int tail = jend[H - 1] > jend[0] ? H - 1 : 0;
#pragma unroll 1
  for (int j0 = 0; j0 < j_both; j0 += KD) step(j0, -1);
#pragma unroll 1
  for (int j0 = j_both; j0 < j_all; j0 += KD) step(j0, tail);

  double* slot = red + (int64_t)wg * (p + 1) * TQ + qcol + 2 * t;
  // The lanes of query tile cq share the reduction; the first stores.
  constexpr int SB = share_bits<QT>();
  const int cq = g >> SB;
  const bool writer = (g & ((1 << SB) - 1)) == 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    double v[QT];
#pragma unroll
    for (int c = 0; c < QT; ++c) {
      v[c] = 0.0;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        v[c] += acc[h][c][e] * acc[h][c][e];
        v[c] += acc[h][c][2 + e] * acc[h][c][2 + e];
      }
    }
    const double x = reduce_tiles(v, lane);
    if (writer) slot[p * TQ + 8 * cq + e] = x;
  }
#pragma unroll 1
  for (int o = 0; o < p; ++o) {
    double al[H][2];
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * mt[h] + g + 8 * hh;
        al[h][hh] = i < n ? __ldg(alpha + (int64_t)i * p + o) : 0.0;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double v[QT];
#pragma unroll
      for (int c = 0; c < QT; ++c) {
        v[c] = 0.0;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          v[c] += acc[h][c][e] * al[h][0];
          v[c] += acc[h][c][2 + e] * al[h][1];
        }
      }
      const double x = reduce_tiles(v, lane);
      if (writer) slot[o * TQ + 8 * cq + e] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// Panel body: N_TILED_MAX < n <= Panel<T>::N_MAX (float32 kernels 2 and 3)
// ---------------------------------------------------------------------------
// Shape of a panel block of NT threads. A warp is WR x WC lanes, each
// thread a TM x TN tile of A (its TN queries in groups of 4, 4 * WC
// apart), so a warp owns WTM rows by WTN queries; QG warps span the TQ
// queries of a tile and RTP warps the PROWS rows of a row panel. chol_inv
// streams through NSLOT slots of PROWS x JC values (JC: 256 bytes of a
// row), row stride LSTR (JC plus 16 bytes: rows start 16-byte aligned).
// The K tile and the staged rows of x are sized by n rounded up to ROUND,
// so few sizes reach the launch cache. N_MAX is the largest count it
// takes: a block at n = 512, d = 16, p = 8 needs 209,920 B (one block, 8
// warps an SM; two up to n = 256 at d = 3). Float32 only: float64 takes
// the DMMA panel body (PanelD).
template <typename T>
struct Panel {
  static_assert(sizeof(T) == 4, "the float64 panel body is PanelD");
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
  static constexpr int JC = 256 / (int)sizeof(T);
  static constexpr int LSTR = JC + 16 / (int)sizeof(T);
  static constexpr int NSLOT = 2;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int ROUND = 64;
  static constexpr int N_MAX = 512;
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
// Float64 panel body on DMMA (kernels 2 and 3 above 192 rows up to
// PanelD::N_MAX, or from 129 where the resident block of bucket 192 does
// not fit)
// ---------------------------------------------------------------------------
// A block of NT threads takes a (query tile, output) item: it evaluates
// K[0:n, TQ] into shared memory, then each warp computes whole 16-row
// tiles of A for all TQ = 64 queries (8 query tiles, 32 accumulators a
// lane), streaming its tiles' chol_inv rows through its own ring of NSLOT
// slots of 16 rows x JC columns by cp.async, synchronised by the warp
// alone. Row tiles go to warps by longest extent first onto the least
// loaded warp (lpt_tiles), from n alone, so a warp's tiles and the order
// of its partial sums do not depend on the query tile. Per k step a warp
// loads 1 A and QT B fragments for QT mma. After the solve each warp's
// partials (registers) go to red, which reuses the K tile's memory, and
// are summed in warp order. One block an SM: a 32-query tile, for two,
// was slower (PERF.md). The K tile and the staged rows are sized by n
// rounded up to ROUND; N_MAX is the largest count it takes (a block at
// n = 256, d = 16, p = 8: 215,040 B).
struct PanelD {
  static constexpr int TQ = 64;
  static constexpr int QT = TQ / 8;  // query tiles a warp
  static constexpr int JC = 16;
  static constexpr int NSLOT = 3;
  static constexpr int SLOT = 16 * JC;
  static constexpr int ROUND = 64;
  static constexpr int N_MAX = 256;
  static_assert(N_MAX <= 16 * 32, "row tiles as bits of a word");
  static_assert(JC % KD == 0, "whole mma steps a slot");
};

// The panel body's largest count and query tile in dtype T.
template <typename T>
__host__ __device__ constexpr int panel_max() {
  if constexpr (sizeof(T) == 4) {
    return Panel<T>::N_MAX;
  } else {
    return PanelD::N_MAX;
  }
}
template <typename T>
__host__ __device__ constexpr int panel_tq() {
  if constexpr (sizeof(T) == 4) {
    return Panel<T>::TQ;
  } else {
    return PanelD::TQ;
  }
}

// The float64 panel body's rows: n rounded up to ROUND.
__host__ __device__ constexpr int dmma_panel_rows(int n) {
  return (n + PanelD::ROUND - 1) / PanelD::ROUND * PanelD::ROUND;
}

// Dynamic shared memory of one float64 panel block: the K tile
// ([dmma_panel_rows][TQ]; later the [NW][p + 1][TQ] partial sums), the
// warps' rings and the staged rows of x and of the mask.
__host__ __device__ constexpr size_t dmma_panel_smem_bytes(int n, int p,
                                                           int d) {
  const size_t rows = (size_t)dmma_panel_rows(n);
  const size_t ks = rows * PanelD::TQ;
  const size_t red = (size_t)NW * (p + 1) * PanelD::TQ;
  return sizeof(double) * ((ks > red ? ks : red) +
                           (size_t)NW * PanelD::NSLOT * PanelD::SLOT +
                           rows * (d + 1));
}

// Dynamic shared memory of one panel block in dtype T.
template <typename T>
__host__ __device__ constexpr size_t panel_bytes(int n, int p, int d) {
  if constexpr (sizeof(T) == 8) {
    return dmma_panel_smem_bytes(n, p, d);
  } else {
    return panel_smem_bytes<T>(n, p, d);
  }
}

// This warp's row tiles (bit m: rows 16m .. 16m + 15) of the M = ceil(n /
// 16) at n rows: longest extent first, each onto the warp with the least
// work so far (the lowest index on a tie).
__device__ __forceinline__ unsigned lpt_tiles(int n, int warp) {
  int load[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) load[w] = 0;
  unsigned mine = 0;
  const int n4 = dmma_rows(n);
  for (int m = (n + 15) / 16 - 1; m >= 0; --m) {
    int best = 0, least = load[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      if (load[w] < least) {
        least = load[w];
        best = w;
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w == best) load[w] += min(n4, 16 * m + 16);
    }
    if (best == warp) mine |= 1u << m;
  }
  return mine;
}

// Walks one warp's chol_inv chunks in order: its row tiles from the
// highest, in each the JC-column chunks up to the tile's extent.
struct WarpCursor {
  unsigned left;
  int n4, m = -1, c = 0, nc = 0;
  __device__ __forceinline__ WarpCursor(unsigned tiles, int n4_)
      : left(tiles), n4(n4_) {
    next_tile();
  }
  __device__ __forceinline__ void next_tile() {
    if (left == 0) {
      m = -1;
      return;
    }
    m = 31 - __clz(left);
    left &= ~(1u << m);
    c = 0;
    nc = (extent() + PanelD::JC - 1) / PanelD::JC;
  }
  __device__ __forceinline__ bool valid() const { return m >= 0; }
  __device__ __forceinline__ int extent() const {
    return min(n4, 16 * m + 16);
  }
  __device__ __forceinline__ bool last_chunk() const { return c == nc - 1; }
  __device__ __forceinline__ void next() {
    if (++c == nc) next_tile();
  }
};

// Start copying the cursor's chunk of chol_inv (rows 16m + r, columns
// c JC + cc) into a warp's slot, swizzled ([16][JC]); elements above the
// diagonal or at or past n are zero-filled without a read.
__device__ __forceinline__ void warp_fetch(double* slot,
                                           const double* __restrict__ chol_inv,
                                           int cap, int n,
                                           const WarpCursor& cur, int lane) {
  constexpr int JC = PanelD::JC;
  const int cc = lane % JC;
  const int col = cur.c * JC + cc;
#pragma unroll
  for (int i = 0; i < PanelD::SLOT / 32; ++i) {
    const int r = lane / JC + i * (32 / JC);
    const int row = 16 * cur.m + r;
    const bool in = row < n && col <= row;
    cp_async<8>(slot + r * JC + swz(r, cc),
                in ? chol_inv + (int64_t)row * cap + col : chol_inv,
                in ? 8 : 0);
  }
}

// A = L^-1 K for one query tile and output on DMMA, into this warp's
// partial sums part[c][e] (c < p: mean, c == P_MAX: var) of queries
// 8 (g >> share_bits<QT>) + 2t + e. `ic` has already started (and
// committed, one group each) the warp's first NSLOT - 1 chunks into its
// slots 0 .. NSLOT - 2; the K tile is in ks. Every lane of the warp must
// call this.
__device__ __forceinline__ void solve_panels_dmma(
    const double* ks, double* ring, WarpCursor& ic, unsigned tiles,
    const double* __restrict__ chol_inv, const double* __restrict__ alpha,
    int cap, int n, int p, int lane, double (&part)[P_MAX + 1][2]) {
  constexpr int TQ = PanelD::TQ, QT = PanelD::QT, JC = PanelD::JC;
  constexpr int NSLOT = PanelD::NSLOT;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c <= P_MAX; ++c) part[c][0] = part[c][1] = 0.0;
  double acc[QT][4];
#pragma unroll
  for (int c = 0; c < QT; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;
  }
  const double* kp = ks + t * TQ;
  int kcol[QT];
#pragma unroll
  for (int c = 0; c < QT; ++c) kcol[c] = swz(t, 8 * c + g);
  const int aoff0 = g * JC, aoff1 = (g + 8) * JC;
  WarpCursor cc(tiles, ic.n4);
  for (int it = 0; cc.valid(); ++it) {
    cp_async_wait<NSLOT - 2>();  // chunk `it` has landed (this lane's part)
    __syncwarp();  // ... every lane's; the slot of chunk it - 1 is free
    if (ic.valid()) {
      warp_fetch(ring + (it + NSLOT - 1) % NSLOT * PanelD::SLOT, chol_inv,
                 cap, n, ic, lane);
      ic.next();
    }
    cp_async_commit();  // one group a chunk, empty past the last
    const double* slot = ring + it % NSLOT * PanelD::SLOT;
    const int j0 = cc.c * JC;
    const int jn = min(JC, cc.extent() - j0);
#pragma unroll
    for (int kk = 0; kk < JC; kk += KD) {
      if (kk >= jn) break;
      double a[KS4][2];
#pragma unroll
      for (int s = 0; s < KS4; ++s) {
        const int col = swz(g, kk + 4 * s + t);
        a[s][0] = slot[aoff0 + col];
        a[s][1] = slot[aoff1 + col];
      }
#pragma unroll
      for (int c = 0; c < QT; ++c) {
        double b[KS4];
#pragma unroll
        for (int s = 0; s < KS4; ++s) {
          b[s] = kp[(j0 + kk + 4 * s) * TQ + kcol[c]];
        }
        dmma(acc[c], a, b);
      }
    }
    if (cc.last_chunk()) {
      // The tile's rows into the partial sums; rows at or past n are
      // exact zeros.
      const int r0 = 16 * cc.m;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        double v[QT];
#pragma unroll
        for (int c = 0; c < QT; ++c) {
          v[c] = acc[c][e] * acc[c][e];
          v[c] += acc[c][2 + e] * acc[c][2 + e];
        }
        part[P_MAX][e] += reduce_tiles(v, lane);
      }
#pragma unroll
      for (int o = 0; o < P_MAX; ++o) {
        if (o >= p) break;
        const int i0 = r0 + g, i1 = r0 + g + 8;
        const double al0 = i0 < n ? __ldg(alpha + (int64_t)i0 * p + o) : 0.0;
        const double al1 = i1 < n ? __ldg(alpha + (int64_t)i1 * p + o) : 0.0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          double v[QT];
#pragma unroll
          for (int c = 0; c < QT; ++c) {
            v[c] = acc[c][e] * al0;
            v[c] += acc[c][2 + e] * al1;
          }
          part[o][e] += reduce_tiles(v, lane);
        }
      }
#pragma unroll
      for (int c = 0; c < QT; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;
      }
    }
    cc.next();
  }
}

// ---------------------------------------------------------------------------
// Strip body: kernels 1-3 above panel_max<T>() (its design is in the header
// note)
// ---------------------------------------------------------------------------
// A thread-block cluster of C = strip_cluster(n) = 2 blocks takes a
// (query tile, output) item of TQ = 64 queries. The rows of A go by panels
// of STRIP_PANEL = 64, in rounds of 4 C panels (the first round takes the
// rest), each round's panels dealt out to the cluster's blocks from n
// alone (strip_deal), STRIP_SLOTS = 4 a block: a block's 256 rows of
// accumulators for all 64 queries, in registers (float32: 2 warps a
// panel, 32 rows a warp, an 8 x 8 tile a thread; float64: 4 warps a
// panel, a 16-row mma tile by 8 query tiles a warp). In a round every
// block walks the same column chunks of JC = 32 in the same order, up to
// the round's last row: it evaluates the chunk's K rows jj = rank, rank +
// C, ... for the item's queries and stores each into the K buffer of
// every block of the cluster (distributed shared memory), and each warp
// streams chol_inv[its rows, chunk] through its own rows of a ring of
// NSLOT slots by cp.async. The next chunk's K (NKB = 3 buffers) and
// chol_inv are in flight while a warp solves this one; the cluster
// barrier is split, its arrival after a block's fill and its wait before
// the next chunk, so a block waits for the others' fills, not for their
// solves. A warp solves a chunk while it starts below the warp's last row
// (or the count). The item's query rows sit in shared memory (qs,
// [TQ][D_MAX + 1]), as do the parameters of a program, so that the fill
// holds no registers through the solve. After a round each warp
// (float32) or panel slot (float64, its warps in turns) reduces its rows
// into its own partial-sum slot red[RED][p + 1][TQ] (stored at the first
// round, added after), and the cluster sums every block's slots through
// distributed shared memory in block-rank, then slot order (strip_store):
// the order of every sum is fixed by n.
constexpr int STRIP_PANEL = 64;  // rows of a panel
constexpr int STRIP_SLOTS = 4;   // panels a block holds
constexpr int STRIP_C_MAX = 8;   // blocks of a cluster (the portable limit)

template <typename T>
struct Strip {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int PANEL = STRIP_PANEL;
  static constexpr int BR = PANEL * STRIP_SLOTS;  // rows a block holds
  static constexpr int TQ = 64;                // queries of an item
  static constexpr int NTH = F32 ? 256 : 512;  // threads of a block
  static constexpr int NWARP = NTH / 32;
  static constexpr int JC = 32;                // columns of a chunk
  static constexpr int NSLOT = 2;              // chol_inv chunks
  static constexpr int NKB = 3;                // K buffers
  static constexpr int BLOCKS = F32 ? 2 : 1;  // blocks an SM
  // Warps of a panel slot (float32: 2 of 32 rows, a thread an 8 x 8
  // tile; float64: 4 of one 16-row mma tile by 8 query tiles) and their
  // rows.
  static constexpr int WSLOT = NWARP / STRIP_SLOTS;
  static constexpr int WROWS = PANEL / WSLOT;
  // Partial-sum slots of a block: one a warp (float32), one a panel slot
  // (float64, its 4 warps adding in turns).
  static constexpr int RED = F32 ? NWARP : STRIP_SLOTS;
  // Row strides of a slot ([JC][SRP], chol_inv transposed) and of a K
  // buffer ([JC][TQP]), padded so that the copies (a warp writes 4 rows x
  // 8 columns in float32, 8 x 4 in float64), the fill and the solve's
  // reads (4 row vectors and 2 K vectors a warp in float32, mma fragments
  // in float64) meet no bank more often than their bytes need.
  static constexpr int SRP = BR + (F32 ? 4 : 8);
  static constexpr int TQP = TQ + (F32 ? 0 : 8);
  static_assert(!F32 || (WROWS == WR * 8 && TQ == WC * 8), "float32 tile");
  static_assert(F32 || WROWS == 16, "float64 tile");
};

// Blocks of the cluster a strip item takes at n rows: 2 at every count,
// so an item's panels go by rounds of 2 STRIP_SLOTS (512 rows). On the
// card clusters of 1, 4 and 8 blocks (K once an item at ceil(n / 256))
// were slower at the refinement chunk and the sampler step at 1,021 rows
// and at kernel 1's 2,048, in both dtypes (PERF.md).
__host__ __device__ constexpr int strip_cluster(int n) {
  return n > 0 ? 2 : 1;
}

// Rounds of a strip item at n rows and C blocks: ceil(panels / 4 C).
__host__ __device__ constexpr int strip_rounds(int n, int csize) {
  const int np = (n + STRIP_PANEL - 1) / STRIP_PANEL;
  const int per = STRIP_SLOTS * csize;
  return (np + per - 1) / per;
}

// Row stride of the item's query rows in shared memory: D_MAX values
// and one more, so that consecutive queries meet different banks.
constexpr int QS_STRIDE = D_MAX + 1;

// Dynamic shared memory of one strip block: the ring, the K buffers, the
// [RED][p + 1][TQ] partial sums and the item's query rows (a program's
// parameters follow, gp_predict_program.cuh). At p = 8: float32 66,560 +
// 24,576 + 18,432 + 4,352 B (two blocks an SM), float64 135,168 + 55,296
// + 18,432 + 8,704 B.
template <typename T>
__host__ __device__ constexpr size_t strip_smem_bytes(int p) {
  using S = Strip<T>;
  return sizeof(T) * ((size_t)S::NSLOT * S::JC * S::SRP +
                      (size_t)S::NKB * S::JC * S::TQP +
                      (size_t)S::RED * (p + 1) * S::TQ +
                      (size_t)S::TQ * QS_STRIDE);
}

// Pointers into a strip block's shared memory (see strip_smem_bytes).
template <typename T>
struct StripSmem {
  using S = Strip<T>;
  T *ring, *kbuf, *red, *qs, *tail;
  __device__ __forceinline__ StripSmem(unsigned char* raw, int p) {
    ring = reinterpret_cast<T*>(raw);
    kbuf = ring + S::NSLOT * S::JC * S::SRP;
    red = kbuf + S::NKB * S::JC * S::TQP;
    qs = red + S::RED * (p + 1) * S::TQ;
    tail = qs + S::TQ * QS_STRIDE;
  }
};

// Stage the query rows q0 .. q0 + TQ - 1 (rows past n_q: the last) into
// qs; the caller synchronises.
template <typename T>
__device__ __forceinline__ void strip_queries(T* qs, const T* __restrict__ q,
                                              int64_t q0, int64_t n_q,
                                              int d) {
  using S = Strip<T>;
  for (int idx = threadIdx.x; idx < S::TQ * d; idx += S::NTH) {
    const int ql = idx / d, c = idx - ql * d;
    const int64_t row = q0 + ql < n_q ? q0 + ql : n_q - 1;
    qs[ql * QS_STRIDE + c] = q[row * d + c];
  }
}

// The panels of round rd of `rounds` dealt to the C blocks of a cluster:
// the last rounds take STRIP_SLOTS * C panels each and the first the rest,
// so that no round walks the columns further than its own rows need. A
// round's panels go longest first (panel i needs i + 1 panels of
// columns), each onto the block with the least work so far and fewer
// than STRIP_SLOTS panels, the lowest rank on a tie. pan[s] are block
// `rank`'s, descending, -1 past its last: from n and C alone. Returns the
// round's last panel + 1.
__device__ __forceinline__ int strip_deal(int n, int csize, int rd,
                                          int rounds, int rank,
                                          int (&pan)[STRIP_SLOTS]) {
  const int np = (n + STRIP_PANEL - 1) / STRIP_PANEL;
  const int per = STRIP_SLOTS * csize;
  const int hi = np - (rounds - 1 - rd) * per;
  const int lo = max(0, hi - per);
  int load[STRIP_C_MAX], cnt[STRIP_C_MAX];
#pragma unroll
  for (int b = 0; b < STRIP_C_MAX; ++b) load[b] = cnt[b] = 0;
#pragma unroll
  for (int s = 0; s < STRIP_SLOTS; ++s) pan[s] = -1;
  for (int i = hi - 1; i >= lo; --i) {
    int best = 0, least = 0x7fffffff;
#pragma unroll
    for (int b = 0; b < STRIP_C_MAX; ++b) {
      if (b < csize && cnt[b] < STRIP_SLOTS && load[b] < least) {
        best = b;
        least = load[b];
      }
    }
#pragma unroll
    for (int b = 0; b < STRIP_C_MAX; ++b) {
      if (b != best) continue;
      if (b == rank) {
#pragma unroll
        for (int s = 0; s < STRIP_SLOTS; ++s) {
          if (s == cnt[b]) pan[s] = i;
        }
      }
      load[b] += i + 1;
      ++cnt[b];
    }
  }
  return hi;
}

// barrier.cluster in its two halves: this thread's arrival (release: its
// stores before it, the K fill's into other blocks among them, are seen by
// every thread of the cluster after its wait) and the wait for the
// current phase's arrivals (acquire). A thread alternates them; the warp
// is converged (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Start copying chol_inv[row0 .. row0 + WROWS - 1, jc0 .. jc0 + JC - 1]
// (row stride cap), one warp's rows, into its rows of a slot (dst: the
// slot's row of columns at the warp's first row), transposed; elements
// above the diagonal or at or past the count are zero-filled without a
// read. A warp instruction copies VR rows by VC consecutive columns (32
// bytes of a row), which meet no bank of the slot more often than their
// bytes need.
template <typename T>
__device__ __forceinline__ void strip_fetch(T* dst,
                                            const T* __restrict__ chol_inv,
                                            int cap, int n, int row0,
                                            int jc0, int lane) {
  using S = Strip<T>;
  constexpr int VC = S::F32 ? 8 : 4;
  constexpr int VR = 32 / VC;
  const int c = lane % VC, r = lane / VC;
#pragma unroll
  for (int cb = 0; cb < S::JC; cb += VC) {
    const int gc = jc0 + cb + c;
#pragma unroll
    for (int rg = 0; rg < S::WROWS; rg += VR) {
      const int gr = row0 + rg + r;
      const bool in = gr < n && gc <= gr;
      cp_async<sizeof(T)>(dst + (cb + c) * S::SRP + rg + r,
                          in ? chol_inv + (int64_t)gr * cap + gc : chol_inv,
                          in ? (int)sizeof(T) : 0);
    }
  }
}

// This block's share of the chunk's K rows (jj = rank, rank + C, ... <
// JC, C the cluster's blocks): K[jc0 + jj][ql] = kfn(jc0 + jj) below n,
// else 0, stored into the K buffer kb of every block of the cluster;
// thread t evaluates query t % TQ.
template <typename T, class KFn>
__device__ __forceinline__ void strip_fill(T* kb, const KFn& kfn, int jc0,
                                           int n) {
  using S = Strip<T>;
  constexpr int JS = S::NTH / S::TQ;  // threads per query
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int ql = threadIdx.x % S::TQ;
  for (int jj = rank + csize * ((int)threadIdx.x / S::TQ); jj < S::JC;
       jj += csize * JS) {
    const int j = jc0 + jj;
    const T v = j < n ? kfn(j) : T(0);
    T* dst = kb + jj * S::TQP + ql;
    for (int b = 0; b < csize; ++b) *cluster.map_shared_rank(dst, b) = v;
  }
}

// Clears a strip's accumulators (float32: one thread's 8 x 8 tile;
// float64: a lane's fragments of one row tile by 8 query tiles).
template <typename T, int N>
__device__ __forceinline__ void strip_zero(T (&acc)[8][N]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) acc[r][c] = T(0);
  }
}

// The float32 solve of one chunk by one thread: acc += L^-1[its rows,
// chunk] K[chunk, its queries], j ascending (the values past the diagonal
// or the count are zeros). lp is its first row in the slot, kp its first
// query in the K buffer.
__device__ __forceinline__ void strip_chunk(float (&acc)[8][8],
                                            const float* lp,
                                            const float* kp) {
  using S = Strip<float>;
#pragma unroll 1
  for (int j8 = 0; j8 < S::JC; j8 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j8 + jj;
      const float4 la = *reinterpret_cast<const float4*>(lp + j * S::SRP);
      const float4 lb =
          *reinterpret_cast<const float4*>(lp + j * S::SRP + 16);
      const float4 ka = *reinterpret_cast<const float4*>(kp + j * S::TQP);
      const float4 kc =
          *reinterpret_cast<const float4*>(kp + j * S::TQP + 4 * WC);
      const float l[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
      const float k[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] += l[r] * k[c];
      }
    }
  }
}

// part[c] summed over the WR row lanes; the lanes of row lane 0 store it
// to (first) or add it to their queries of dst ([TQ]).
__device__ __forceinline__ void strip_add(float (&part)[8], float* dst,
                                          int lr, int lc, bool first) {
#pragma unroll
  for (int off = WC; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      part[c] += __shfl_xor_sync(0xffffffffu, part[c], off);
    }
  }
  if (lr == 0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* q = dst + (c / 4) * 4 * WC + 4 * lc + c % 4;
      *q = first ? part[c] : *q + part[c];
    }
  }
}

// The end of a float32 round: this thread's rows (row0 + {0..3, 16..19};
// none where its panel slot is empty) into alpha^T A and sum A^2 over the
// row lanes, stored (first round) or added to the warp's partial sums
// red[c][q]. Rows at or past n hold exact zeros. Clears acc.
__device__ __forceinline__ void strip_reduce(float (&acc)[8][8], float* red,
                                             const float* __restrict__ alpha,
                                             int row0, bool held, int n,
                                             int p, int lr, int lc,
                                             bool first) {
  constexpr int TQ = Strip<float>::TQ;
  float part[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    part[c] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) part[c] += acc[r][c] * acc[r][c];
  }
  strip_add(part, red + p * TQ, lr, lc, first);
#pragma unroll 1
  for (int out = 0; out < p; ++out) {
    float a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = row0 + r % 4 + 16 * (r / 4);
      a[r] = held && row < n ? __ldg(alpha + (int64_t)row * p + out) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      part[c] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) part[c] += acc[r][c] * a[r];
    }
    strip_add(part, red + out * TQ, lr, lc, first);
  }
  strip_zero(acc);
}

// The float64 solve of one chunk (JC / KD mma k steps) by one warp on
// DMMA: acc += L^-1[its tile, chunk] K[chunk, 64 queries]. lp is the
// lane's first A element in the slot (row g of the tile, column t), kp
// its first B element in the K buffer (row t, query g).
__device__ __forceinline__ void strip_chunk_dmma(double (&acc)[8][4],
                                                 const double* lp,
                                                 const double* kp) {
  using S = Strip<double>;
#pragma unroll 1
  for (int kk = 0; kk < S::JC; kk += KD) {
    double a[KS4][2];
#pragma unroll
    for (int s = 0; s < KS4; ++s) {
      a[s][0] = lp[(kk + 4 * s) * S::SRP];
      a[s][1] = lp[(kk + 4 * s) * S::SRP + 8];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      double b[KS4];
#pragma unroll
      for (int s = 0; s < KS4; ++s) b[s] = kp[(kk + 4 * s) * S::TQP + 8 * c];
      dmma(acc[c], a, b);
    }
  }
}

// The end of a float64 round: the warp's tile (rows row0 + g + 8 h; none
// where its panel slot is empty) into alpha^T A and sum A^2, reduced over
// the g lanes (reduce_tiles: lane g holds query tile g) and stored (first)
// or added to its panel slot's partial sums red[c][q]. Rows at or past n
// hold exact zeros. Clears acc.
__device__ __forceinline__ void strip_reduce_dmma(
    double (&acc)[8][4], double* red, const double* __restrict__ alpha,
    int row0, bool held, int n, int p, int lane, bool first) {
  constexpr int TQ = Strip<double>::TQ;
  const int g = lane >> 2, t = lane & 3;
  auto put = [&](double* dst, int e, double x) {
    double* q = dst + 8 * g + 2 * t + e;
    *q = first ? x : *q + x;
  };
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    double v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = acc[c][e] * acc[c][e];
      v[c] += acc[c][2 + e] * acc[c][2 + e];
    }
    put(red + p * TQ, e, reduce_tiles(v, lane));
  }
#pragma unroll 1
  for (int o = 0; o < p; ++o) {
    const int i0 = row0 + g, i1 = row0 + g + 8;
    const double al0 =
        held && i0 < n ? __ldg(alpha + (int64_t)i0 * p + o) : 0.0;
    const double al1 =
        held && i1 < n ? __ldg(alpha + (int64_t)i1 * p + o) : 0.0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[c] = acc[c][e] * al0;
        v[c] += acc[c][2 + e] * al1;
      }
      put(red + o * TQ, e, reduce_tiles(v, lane));
    }
  }
  strip_zero(acc);
}

// A = L^-1 K for one item (query tile, output) by this block's panels, and
// its reductions into red ([RED][p + 1][TQ]); fill(kb, jc0) stores this
// block's share of the output's K rows jc0 .. jc0 + JC - 1 into every
// block's K buffer kb (strip_fill). Every thread of every block of the
// cluster must call this; on return every block's partials are in its red.
template <typename T, class Fill>
__device__ __forceinline__ void solve_strips(T* ring, T* kbuf, T* red,
                                             const Fill& fill,
                                             const T* __restrict__ chol_inv,
                                             const T* __restrict__ alpha,
                                             int cap, int n, int p) {
  using S = Strip<T>;
  constexpr int SLOT = S::JC * S::SRP;
  constexpr int KB = S::JC * S::TQP;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This warp's panel slot and its rows there (float32: 32 rows, a thread
  // 8 of them; float64: one 16-row mma tile); this thread's first element
  // in a slot and in a K buffer.
  const int ws = warp / S::WSLOT;
  const int wrow = (warp % S::WSLOT) * S::WROWS;
  int lrow, kq;
  if constexpr (S::F32) {
    lrow = S::PANEL * ws + wrow + 4 * (lane / WC);
    kq = 4 * (lane % WC);
  } else {
    lrow = (lane & 3) * S::SRP + S::PANEL * ws + wrow + (lane >> 2);
    kq = (lane & 3) * S::TQP + (lane >> 2);
  }
  T acc[8][S::F32 ? 8 : 4];
  const int rounds = strip_rounds(n, csize);
  for (int rd = 0; rd < rounds; ++rd) {
    int pan[STRIP_SLOTS];
    const int end = min(n, S::PANEL * strip_deal(n, csize, rd, rounds, rank,
                                              pan));
    const int nch = (end + S::JC - 1) / S::JC;
    // The warp's panel, its first row there, and the end of its work: the
    // chunks below its last row (or the count).
    int mine = -1;
#pragma unroll
    for (int s = 0; s < STRIP_SLOTS; ++s) {
      if (s == ws) mine = pan[s];
    }
    const int row0 = S::PANEL * mine + wrow;
    const int wend = mine >= 0 ? min(n, row0 + S::WROWS) : 0;
    T* wring = ring + S::PANEL * ws + wrow;  // the warp's rows of slot 0
    if (wend > 0) strip_fetch(wring, chol_inv, cap, n, row0, 0, lane);
    cp_async_commit();
    fill(kbuf, 0);
    cluster_arrive();
    strip_zero(acc);
    for (int t = 0; t < nch; ++t) {
      // Every block's share of chunk t's K is in every K buffer, and every
      // block is done with chunk t - 2, whose buffer the next fill takes.
      cluster_wait();
      const int jn = (t + 1) * S::JC;
      if (jn < wend) {
        strip_fetch(wring + (t + 1) % S::NSLOT * SLOT, chol_inv, cap, n,
                    row0, jn, lane);
      }
      cp_async_commit();  // one group a chunk, empty where none is copied
      if (t + 1 < nch) fill(kbuf + (t + 1) % S::NKB * KB, jn);
      cluster_arrive();
      if (t * S::JC < wend) {
        cp_async_wait<1>();  // chunk t's chol_inv has landed (this lane's)
        __syncwarp();        // ... the warp's
        const T* slot = ring + t % S::NSLOT * SLOT;
        const T* kb = kbuf + t % S::NKB * KB;
        if constexpr (S::F32) {
          strip_chunk(acc, slot + lrow, kb + kq);
        } else {
          strip_chunk_dmma(acc, slot + lrow, kb + kq);
        }
      }
    }
    cluster_wait();
    cp_async_wait<0>();
    const bool held = mine >= 0;
    if constexpr (S::F32) {
      strip_reduce(acc, red + warp * (p + 1) * S::TQ, alpha,
                   row0 + 4 * (lane / WC), held, n, p, lane / WC, lane % WC,
                   rd == 0);
    } else {
      // The 4 tiles of a panel slot add into its partial sums in turns.
#pragma unroll 1
      for (int i = 0; i < S::WSLOT; ++i) {
        if (warp % S::WSLOT == i) {
          strip_reduce_dmma(acc, red + ws * (p + 1) * S::TQ, alpha, row0,
                            held, n, p, lane, rd == 0 && i == 0);
        }
        __syncthreads();
      }
    }
    // Every block's partials of the round are in its red; every block is
    // done with the round's buffers.
    cluster.sync();
  }
}

// Store output `out` of the item at q0: each value the sum of every
// block's partial-sum slots of the cluster (distributed shared memory), in
// block-rank, then slot order, the cluster's threads taking the values in
// turns. Every block's red is complete (solve_strips ends in a cluster
// barrier); the caller synchronises the cluster before red is reused.
template <typename T>
__device__ __forceinline__ void strip_store(T* red, int64_t q0, int64_t n_q,
                                            int p, int n_out, int out,
                                            T* __restrict__ mean_out,
                                            T* __restrict__ var_out) {
  using S = Strip<T>;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per = (p + 1) * S::TQ;
  for (int idx = rank * S::NTH + (int)threadIdx.x; idx < per;
       idx += csize * S::NTH) {
    const int c = idx / S::TQ;
    const int ql = idx - c * S::TQ;
    const int64_t qi = q0 + ql;
    if (qi >= n_q) continue;
    T sum = T(0);
    for (int b = 0; b < csize; ++b) {
      const T* rb = cluster.map_shared_rank(red, b);
#pragma unroll
      for (int w = 0; w < S::RED; ++w) {
        const T v = rb[(w * (p + 1) + c) * S::TQ + ql];
        sum = b == 0 && w == 0 ? v : sum + v;
      }
    }
    if (c < p) {
      mean_out[(qi * n_out + out) * p + c] = sum;
    } else {
      var_out[qi * n_out + out] = sum;
    }
  }
}

// What the launches of one strip instantiation ask of the CUDA runtime,
// asked once per device, dynamic shared-memory size and cluster size: the
// clusters the device holds at once. On a miss the kernel's shared-memory
// opt-in is raised to the largest size seen on that device, as in
// GridCache.
struct ClusterCache {
  static constexpr int N = 16;
  std::mutex lock;
  int n = 0;
  int dev[N];
  size_t smem[N];
  int csize[N];
  int clusters[N];
};

// A launch configuration of `blocks` blocks of `threads` threads in
// clusters of csize (attr holds the cluster dimension).
inline cudaLaunchConfig_t cluster_config(int64_t blocks, int threads,
                                         size_t smem, int csize,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of csize `threads`-thread blocks the device holds at once
// (cudaOccupancyMaxActiveClusters), at least 1, else an error: a cluster
// that does not fit is refused, never run otherwise.
template <class Kernel>
inline cudaError_t cluster_grid(ClusterCache& cache, Kernel kernel,
                                size_t smem, int threads, int csize,
                                int* clusters) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(cache.lock);
  size_t opt_in = smem;
  for (int i = 0; i < cache.n; ++i) {
    if (cache.dev[i] != dev) continue;
    if (cache.smem[i] == smem && cache.csize[i] == csize) {
      *clusters = cache.clusters[i];
      return cudaSuccess;
    }
    if (cache.smem[i] > opt_in) opt_in = cache.smem[i];
  }
  // Above 48 KB a launch is refused unless the kernel opts in.
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)opt_in);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(csize, threads, smem, csize, nullptr, &attr);
  int found = 0;
  err = cudaOccupancyMaxActiveClusters(&found, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (found < 1) return cudaErrorInvalidConfiguration;
  // A full cache asks again next time.
  if (cache.n < ClusterCache::N) {
    cache.dev[cache.n] = dev;
    cache.smem[cache.n] = smem;
    cache.csize[cache.n] = csize;
    cache.clusters[cache.n] = found;
    ++cache.n;
  }
  *clusters = found;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Streamed body: kernels 4-7 above N_TILED_MAX, and the comparison entries
// of kernels 1-3 at any count
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
