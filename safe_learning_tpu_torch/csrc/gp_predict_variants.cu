// Four variants of kernel 1's fused GP posterior predict, for Hopper
// (sm_90a). Each computes the function of gp_predict.cu, the posterior
// numerators of a stationary GP over the n = count active rows,
//
//   k_j       = cov_kind(r2_j) * var_s2 * mask_j          (j < n)
//   a         = chol_inv[:n, :n] * k
//   mean[q,:] = a^T alpha[:n],   var[q] = sum_i a_i^2,
//
// by another schedule or another algebra. They replace the four Pallas
// TPU kernels written as design probes of kernel 1:
//
//   gp_pipelined   benchmarks/pipelined_predict.py:44  _pipelined_kernel
//   gp_interleaved benchmarks/pipelined_predict.py:141 _interleaved_kernel
//   gp_folded      benchmarks/pipelined_predict.py:170 _folded_kernel
//   gp_expanded    benchmarks/distance_mxu_experiment.py:30 _kernel_mxu
//
// No path of the package routes through them; the port's benchmark
// modules (safe_learning_tpu_torch/benchmarks/) time them beside kernel 1.
//
// What bounds them on the H100 is what bounds kernel 1 (gp_predict.cu):
// FP32 FMAs on the CUDA cores, the solve fed from shared memory, never
// device memory. Each variant asks one question about kernel 1's tiled
// body (fill k, barrier, solve, barrier, store, per query tile):
//
//   - pipelined: the k tile and the partial sums are doubled into two
//     slots. In iteration t a block solves tile t from one slot and builds
//     tile t+1's k into the other, so one barrier a tile separates the
//     stages instead of two, and one warp's expf may overlap another's
//     FMAs. The TPU's extra drain step of the grid is the loop's prologue
//     (build the first tile) and its last iteration (solve only).
//   - interleaved<H>, H in {2, 4}: a block takes H tiles at a time; each
//     sub-tile builds its k and runs its solve, and sub-tile h+1's build
//     follows sub-tile h's solve with no barrier between (the k tile is a
//     ring of two slots; every sub-tile has its own partial sums, stored
//     after the group's last barrier): H + 1 barriers for H tiles.
//   - folded: k is the bare cov_kind(r2); the wrapper has folded
//     var_s2 * mask into the columns of chol_inv once per call, as the JAX
//     wrapper does outside its body. Two multiplies less per (row, query).
//   - expanded: r2 = max(xx_j - 2 sum_c x_jc q_c + qq, 0), xx_j staged per
//     row in shared memory beside x, qq per query in a register; FP32 (or
//     FP64) on the CUDA cores, never TF32. The cross term is d FMAs where
//     the differences are d subtractions and d FMAs, at a cost in accuracy
//     (cancellation in xx + qq - 2 x.q near r2 = 0; the clamp keeps r2 >= 0).
//
// Above 128 rows, and where a tiled block does not fit in shared memory
// (float64 with many outputs or dimensions), every variant takes the
// streamed body of gp_predict_common.cuh, which reads chol_inv from
// device memory in row tiles and recomputes k in chunks: any count up to
// kernel_max_capacity = 2048. The pipelined and interleaved variants have
// no tile to pipeline or split there and run kernel 1's streamed body;
// the folded and expanded variants keep their own k function.
//
// The tiled bodies use one bucket, NB = 128, for every count <= 128 (the
// loops stop at the count; kernel 1's smaller buckets are its tuning, not
// what these variants probe). The RBF family, the one the benchmarks time
// (the bench's and the cart-pole's GPs), is a template parameter as in
// kernel 1; the other three families share one instantiation that reads
// the family at run time (a branch uniform over the block), and so does
// the streamed body: 26 kernels where one per family would be 64, which
// keeps the library's build near kernel 1's. float32 blocks have 256
// threads; float64 pipelined and interleaved blocks 128, whose tile is 32
// queries wide, so that chol_inv (128 KB in float64) and two k slots fit
// in the 227 KB a block may use. Loops are bounded by the host's count,
// padded rows are exact zeros (gp_predict.cu), no fast-math.

#include "gp_predict_stationary.cuh"

namespace {

using namespace gp_common;

// How k_j is formed.
enum KForm { K_STATIONARY = 0, K_BARE = 1, K_EXPANDED = 2 };

// The family read at run time (Args::kind) instead of fixed.
constexpr int KIND_ANY = -1;

template <typename T, int KIND>
__device__ __forceinline__ T cov_of(T r2, int kind) {
  if constexpr (KIND != KIND_ANY) {
    return covariance<T, KIND>(r2);
  } else {
    switch (kind) {
      case RBF:
        return cov_rbf(r2);
      case MATERN12:
        return cov_matern12(r2);
      case MATERN32:
        return cov_matern32(r2);
      default:
        return cov_matern52(r2);
    }
  }
}

constexpr int NBV = N_TILED_MAX;  // the one tiled bucket

template <typename T>
struct Args {
  const T *q, *x, *chol_inv, *alpha, *mask, *var_s2;
  int64_t n_q;
  int d, cap, n, p, kind;
  T *mean_out, *var_out;
};

// sum_c q_c^2 of one query (registers, then its row past 4 dimensions).
template <typename T>
__device__ __forceinline__ T sq_norm(const T (&qv)[D_MAX],
                                     const T* __restrict__ qrow, int d) {
  T s = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < d) s = s + qv[c] * qv[c];
  }
  for (int c = 4; c < d; ++c) s = s + qrow[c] * qrow[c];
  return s;
}

// sum_c x_jc^2 of one training row.
template <typename T>
__device__ __forceinline__ T row_sq_norm(const T* xj, int d) {
  T s = T(0);
  for (int c = 0; c < d; ++c) s = s + xj[c] * xj[c];
  return s;
}

// k_j in the form KF, of family KIND (or `kind` for KIND_ANY). x, mask
// and xx (the rows' squared norms) in shared or global memory; a null xx
// (the streamed body) computes xx_j here. The stationary form is
// stationary_k's arithmetic.
template <typename T, int KIND, int KF>
__device__ __forceinline__ T variant_k(const T* x, const T* mask,
                                       const T* xx, const T (&qv)[D_MAX],
                                       const T* __restrict__ qrow, T qq,
                                       int d, T var_s2, int kind, int j) {
  const T* xj = x + (int64_t)j * d;
  if constexpr (KF == K_STATIONARY) {
    return cov_of<T, KIND>(sq_dist(xj, qv, qrow, d), kind) * var_s2 *
           mask[j];
  } else if constexpr (KF == K_BARE) {
    return cov_of<T, KIND>(sq_dist(xj, qv, qrow, d), kind);
  } else {
    T cross = T(0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < d) cross = cross + xj[c] * qv[c];
    }
    for (int c = 4; c < d; ++c) cross = cross + xj[c] * qrow[c];
    const T xxj = xx != nullptr ? xx[j] : row_sq_norm(xj, d);
    T r2 = xxj - T(2) * cross + qq;
    r2 = r2 > T(0) ? r2 : T(0);
    return cov_of<T, KIND>(r2, kind) * var_s2 * mask[j];
  }
}

// Shared memory of a tiled variant block: chol_inv transposed, KSS k
// slots, RS partial-sum slots, the active rows of x, the mask and the
// rows' squared norms.
template <typename T, int NTH>
struct VSmem {
  using TL = Tile<NBV, NTH>;
  static constexpr int KS = NBV * TL::TQ;  // values of one k slot

  static __host__ __device__ constexpr int red_size(int p) {
    return TL::SLOTS * (p + 1) * TL::TQ;
  }
  static __host__ __device__ constexpr size_t bytes(int kss, int rs, int p,
                                                    int d) {
    return sizeof(T) * ((size_t)NBV * ls_stride<T>(NBV) + (size_t)kss * KS +
                        (size_t)rs * red_size(p) + (size_t)NBV * (d + 2));
  }

  T *ls, *ks, *red, *xs, *ms, *xx;
  int rsize;
  __device__ __forceinline__ VSmem(unsigned char* raw, int kss, int rs,
                                   int p, int d)
      : ls(reinterpret_cast<T*>(raw)),
        ks(ls + NBV * ls_stride<T>(NBV)),
        red(ks + kss * KS),
        xs(red + rs * red_size(p)),
        ms(xs + NBV * d),
        xx(ms + NBV),
        rsize(red_size(p)) {}
  __device__ __forceinline__ T* k_slot(int s) const { return ks + s * KS; }
  __device__ __forceinline__ T* red_slot(int s) const {
    return red + s * rsize;
  }
};

// Stage chol_inv[:n, :n] transposed and the active rows (x, and the mask
// and squared norms where the form reads them), then synchronise.
template <typename T, int NTH, int KF>
__device__ __forceinline__ void stage(const VSmem<T, NTH>& sm,
                                      const Args<T>& a) {
  stage_chol_inv<T, NBV, NTH>(sm.ls, a.chol_inv, a.cap, a.n);
  for (int idx = threadIdx.x; idx < a.n * a.d; idx += NTH) {
    sm.xs[idx] = a.x[idx];
  }
  for (int j = threadIdx.x; j < a.n; j += NTH) {
    if (KF != K_BARE) sm.ms[j] = a.mask[j];
    if (KF == K_EXPANDED) sm.xx[j] = row_sq_norm(a.x + (int64_t)j * a.d, a.d);
  }
  __syncthreads();
}

// k of query tile t into the slot ks (all threads of the block).
template <typename T, int KIND, int KF, int NTH>
__device__ __forceinline__ void build_tile(const VSmem<T, NTH>& sm, T* ks,
                                           const Args<T>& a, T var_s2,
                                           int64_t t) {
  constexpr int TQ = Tile<NBV, NTH>::TQ;
  const int64_t qi = t * TQ + threadIdx.x % TQ;
  T qv[D_MAX];
  load_row(a.q, qi, a.n_q, a.d, qv);
  const T* qrow = query_row(a.q, qi, a.n_q, a.d);
  const T qq = KF == K_EXPANDED ? sq_norm(qv, qrow, a.d) : T(0);
  fill_k<T, NBV, NTH>(ks, [&](int j) {
    return variant_k<T, KIND, KF>(sm.xs, sm.ms, sm.xx, qv, qrow, qq, a.d,
                                  var_s2, a.kind, j);
  }, a.n);
}

template <typename T>
__device__ __forceinline__ T scale_of(const Args<T>& a) {
  return a.var_s2 != nullptr ? *a.var_s2 : T(1);
}

// Kernel 1's schedule with the k form KF (folded, expanded): per tile,
// build, barrier, solve, barrier, store.
template <typename T, int KIND, int KF>
__global__ void __launch_bounds__(NT, (tiled_min_blocks<T, NBV>()))
tiled_serial(const Args<T> a) {
  constexpr int TQ = Tile<NBV, NT>::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VSmem<T, NT> sm(smem_raw, 1, 1, a.p, a.d);
  stage<T, NT, KF>(sm, a);
  const T var_s2 = scale_of(a);
  const int64_t n_tiles = (a.n_q + TQ - 1) / TQ;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    build_tile<T, KIND, KF, NT>(sm, sm.k_slot(0), a, var_s2, t);
    __syncthreads();  // k staged
    solve_tile<T, NBV, NT>(sm.k_slot(0), sm.ls, sm.red_slot(0), a.alpha,
                           a.n, a.p);
    __syncthreads();  // partials written; k may be overwritten
    store_tile<T, NBV, NT>(sm.red_slot(0), t * TQ, a.n_q, a.p, 1, 0,
                           a.mean_out, a.var_out);
  }
}

// The pipelined schedule: solve tile t from slot i % 2 while building the
// block's next tile into the other slot; one barrier a tile.
template <typename T, int KIND, int NTH>
__global__ void __launch_bounds__(NTH, 1) tiled_pipelined(const Args<T> a) {
  constexpr int TQ = Tile<NBV, NTH>::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VSmem<T, NTH> sm(smem_raw, 2, 2, a.p, a.d);
  stage<T, NTH, K_STATIONARY>(sm, a);
  const T var_s2 = scale_of(a);
  const int64_t n_tiles = (a.n_q + TQ - 1) / TQ;
  int64_t t = blockIdx.x;
  if (t >= n_tiles) return;  // uniform over the block
  // Prologue: the first tile's k.
  build_tile<T, KIND, K_STATIONARY, NTH>(sm, sm.k_slot(0), a, var_s2, t);
  __syncthreads();
  for (int s = 0; t < n_tiles; t += gridDim.x, s ^= 1) {
    // Slot s holds tile t's k (built before the last barrier); slot s ^ 1
    // and partials s ^ 1 were last read before it.
    solve_tile<T, NBV, NTH>(sm.k_slot(s), sm.ls, sm.red_slot(s), a.alpha,
                            a.n, a.p);
    if (t + gridDim.x < n_tiles) {
      build_tile<T, KIND, K_STATIONARY, NTH>(sm, sm.k_slot(s ^ 1), a, var_s2,
                                             t + gridDim.x);
    }
    __syncthreads();  // partials s written, next k built
    store_tile<T, NBV, NTH>(sm.red_slot(s), t * TQ, a.n_q, a.p, 1, 0,
                            a.mean_out, a.var_out);
  }
}

// The interleaved schedule: HS consecutive tiles a group. Sub-tile h's
// solve is followed by sub-tile h+1's build (k slots alternate) with no
// barrier between; each sub-tile has its own partials, stored after the
// group's last barrier.
template <typename T, int KIND, int NTH, int HS>
__global__ void __launch_bounds__(NTH, 1)
tiled_interleaved(const Args<T> a) {
  constexpr int TQ = Tile<NBV, NTH>::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const VSmem<T, NTH> sm(smem_raw, 2, HS, a.p, a.d);
  stage<T, NTH, K_STATIONARY>(sm, a);
  const T var_s2 = scale_of(a);
  const int64_t n_tiles = (a.n_q + TQ - 1) / TQ;
  const int64_t n_groups = (n_tiles + HS - 1) / HS;
  for (int64_t g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int64_t t0 = g * HS;
    build_tile<T, KIND, K_STATIONARY, NTH>(sm, sm.k_slot(0), a, var_s2, t0);
#pragma unroll
    for (int h = 0; h < HS; ++h) {
      // Sub-tile h's k built; the slot sub-tile h+1 builds into was last
      // read by sub-tile h-1's solve, before this barrier; at h = 0 the
      // previous group's stores are done.
      __syncthreads();
      solve_tile<T, NBV, NTH>(sm.k_slot(h % 2), sm.ls, sm.red_slot(h),
                              a.alpha, a.n, a.p);
      if (h + 1 < HS) {
        build_tile<T, KIND, K_STATIONARY, NTH>(sm, sm.k_slot((h + 1) % 2), a,
                                               var_s2, t0 + h + 1);
      }
    }
    __syncthreads();  // every sub-tile's partials written
#pragma unroll
    for (int h = 0; h < HS; ++h) {
      store_tile<T, NBV, NTH>(sm.red_slot(h), (t0 + h) * TQ, a.n_q, a.p, 1,
                              0, a.mean_out, a.var_out);
    }
  }
}

// Streamed body: one query per thread, chol_inv from device memory; the
// family read at run time.
template <typename T, int KF>
__global__ void __launch_bounds__(NTS) streamed(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [CB][NTS]: k per thread
  T* ls = ks + (int64_t)CB * NTS;          // [CB][LS]: chol_inv tile^T

  const int64_t qi = (int64_t)blockIdx.x * NTS + threadIdx.x;
  T qv[D_MAX];
  load_row(a.q, qi, a.n_q, a.d, qv);
  const T* qrow = query_row(a.q, qi, a.n_q, a.d);
  const T qq = KF == K_EXPANDED ? sq_norm(qv, qrow, a.d) : T(0);
  const T var_s2 = scale_of(a);

  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);
  solve_streamed(ks, ls, [&](int j) {
    return variant_k<T, KIND_ANY, KF>(a.x, a.mask, nullptr, qv, qrow, qq,
                                      a.d, var_s2, a.kind, j);
  }, a.chol_inv, a.alpha, a.cap, a.n, a.p, macc, vacc);

  if (qi >= a.n_q) return;
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) {
    if (c < a.p) a.mean_out[qi * a.p + c] = macc[c];
  }
  a.var_out[qi] = vacc;
}

template <typename T, int KF>
cudaError_t launch_streamed(const Args<T>& a, cudaStream_t stream) {
  auto kernel = streamed<T, KF>;
  const size_t smem = streamed_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (a.n_q + NTS - 1) / NTS;
  kernel<<<(unsigned)blocks, NTS, smem, stream>>>(a);
  return cudaGetLastError();
}

// A tiled kernel of NTH threads on a persistent grid over items of `tq`
// queries (a tile, or a group of HS tiles).
template <class Kernel, typename T>
cudaError_t launch_persistent(GridCache& cache, Kernel kernel, size_t smem,
                              int tq, int nth, const Args<T>& a,
                              cudaStream_t stream) {
  int grid = 0;
  const cudaError_t err =
      persistent_grid(cache, kernel, smem, a.n_q, tq, &grid, nth);
  if (err != cudaSuccess) return err;
  kernel<<<grid, nth, smem, stream>>>(a);
  return cudaGetLastError();
}

// Block threads of the pipelined and interleaved bodies: a 32-query tile
// in float64, so that two k slots fit beside chol_inv.
template <typename T>
constexpr int nth_of() {
  return sizeof(T) == 4 ? NT : NT / 2;
}

template <typename T, int KIND, int KF>
cudaError_t launch_serial(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  const size_t smem = VSmem<T, NT>::bytes(1, 1, a.p, a.d);
  if (a.n > NBV || smem > SMEM_MAX) {
    return launch_streamed<T, KF>(a, stream);
  }
  return launch_persistent(cache, tiled_serial<T, KIND, KF>, smem,
                           Tile<NBV, NT>::TQ, NT, a, stream);
}

template <typename T, int KIND>
cudaError_t launch_pipelined(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  constexpr int NTH = nth_of<T>();
  const size_t smem = VSmem<T, NTH>::bytes(2, 2, a.p, a.d);
  if (a.n > NBV || smem > SMEM_MAX) {
    return launch_streamed<T, K_STATIONARY>(a, stream);
  }
  return launch_persistent(cache, tiled_pipelined<T, KIND, NTH>, smem,
                           Tile<NBV, NTH>::TQ, NTH, a, stream);
}

template <typename T, int KIND, int HS>
cudaError_t launch_interleaved(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  constexpr int NTH = nth_of<T>();
  const size_t smem = VSmem<T, NTH>::bytes(2, HS, a.p, a.d);
  if (a.n > NBV || smem > SMEM_MAX) {
    return launch_streamed<T, K_STATIONARY>(a, stream);
  }
  return launch_persistent(cache, tiled_interleaved<T, KIND, NTH, HS>, smem,
                           HS * Tile<NBV, NTH>::TQ, NTH, a, stream);
}

enum Variant { PIPELINED = 0, INTERLEAVED2 = 1, INTERLEAVED4 = 2, FOLDED = 3,
               EXPANDED = 4 };

template <typename T, int KIND>
cudaError_t launch_variant(int variant, const Args<T>& a,
                           cudaStream_t stream) {
  switch (variant) {
    case PIPELINED:
      return launch_pipelined<T, KIND>(a, stream);
    case INTERLEAVED2:
      return launch_interleaved<T, KIND, 2>(a, stream);
    case INTERLEAVED4:
      return launch_interleaved<T, KIND, 4>(a, stream);
    case FOLDED:
      return launch_serial<T, KIND, K_BARE>(a, stream);
    case EXPANDED:
      return launch_serial<T, KIND, K_EXPANDED>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(int variant, const void* q, const void* x, const void* chol_inv,
           const void* alpha, const void* mask, const void* var_s2,
           int64_t n_q, int d, int cap, int count, int p, int kind,
           void* mean_out, void* var_out, void* stream) {
  if (n_q <= 0 || d < 1 || d > D_MAX || p < 1 || p > P_MAX || cap < 1 ||
      count < 0 || count > cap || (n_q + NTS - 1) / NTS > 0x7fffffffLL ||
      kind < RBF || kind > MATERN52 ||
      (variant != FOLDED && (mask == nullptr || var_s2 == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(x),
                  static_cast<const T*>(chol_inv),
                  static_cast<const T*>(alpha), static_cast<const T*>(mask),
                  static_cast<const T*>(var_s2), n_q, d, cap, count, p,
                  kind, static_cast<T*>(mean_out), static_cast<T*>(var_out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kind == RBF ? launch_variant<T, RBF>(variant, a, st)
                           : launch_variant<T, KIND_ANY>(variant, a, st));
}

int dispatch(int itemsize, int variant, const void* q, const void* x,
             const void* chol_inv, const void* alpha, const void* mask,
             const void* var_s2, int64_t n_q, int d, int cap, int count,
             int p, int kind, void* mean_out, void* var_out, void* stream) {
  if (itemsize == 4) {
    return launch<float>(variant, q, x, chol_inv, alpha, mask, var_s2, n_q,
                         d, cap, count, p, kind, mean_out, var_out, stream);
  }
  if (itemsize == 8) {
    return launch<double>(variant, q, x, chol_inv, alpha, mask, var_s2, n_q,
                          d, cap, count, p, kind, mean_out, var_out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes: one entry point a variant. Every
// pointer is a device pointer except `stream` (a cudaStream_t);
// `itemsize` is 4 (float32) or 8 (float64); `count` is the number of
// active rows (0 <= count <= cap), under kernel 1's precondition
// (ops/gp_kernel.py). Each returns a cudaError_t; 0 is success.
extern "C" {

int gp_pipelined(int itemsize, const void* q, const void* x,
                 const void* chol_inv, const void* alpha, const void* mask,
                 const void* var_s2, int64_t n_q, int d, int cap, int count,
                 int p, int kind, void* mean_out, void* var_out,
                 void* stream) {
  return dispatch(itemsize, PIPELINED, q, x, chol_inv, alpha, mask, var_s2,
                  n_q, d, cap, count, p, kind, mean_out, var_out, stream);
}

// `halves` is 2 or 4: the tiles of a group.
int gp_interleaved(int itemsize, int halves, const void* q, const void* x,
                   const void* chol_inv, const void* alpha, const void* mask,
                   const void* var_s2, int64_t n_q, int d, int cap,
                   int count, int p, int kind, void* mean_out, void* var_out,
                   void* stream) {
  if (halves != 2 && halves != 4) return (int)cudaErrorInvalidValue;
  return dispatch(itemsize, halves == 2 ? INTERLEAVED2 : INTERLEAVED4, q, x,
                  chol_inv, alpha, mask, var_s2, n_q, d, cap, count, p, kind,
                  mean_out, var_out, stream);
}

// `chol_inv_scaled` is chol_inv * (var_s2 * mask)[None, :]; no mask, no
// scale.
int gp_folded(int itemsize, const void* q, const void* x,
              const void* chol_inv_scaled, const void* alpha, int64_t n_q,
              int d, int cap, int count, int p, int kind, void* mean_out,
              void* var_out, void* stream) {
  return dispatch(itemsize, FOLDED, q, x, chol_inv_scaled, alpha, nullptr,
                  nullptr, n_q, d, cap, count, p, kind, mean_out, var_out,
                  stream);
}

int gp_expanded(int itemsize, const void* q, const void* x,
                const void* chol_inv, const void* alpha, const void* mask,
                const void* var_s2, int64_t n_q, int d, int cap, int count,
                int p, int kind, void* mean_out, void* var_out,
                void* stream) {
  return dispatch(itemsize, EXPANDED, q, x, chol_inv, alpha, mask, var_s2,
                  n_q, d, cap, count, p, kind, mean_out, var_out, stream);
}

const char* gp_variant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gp_variant_limits(int* d_max, int* p_max) {
  *d_max = D_MAX;
  *p_max = P_MAX;
  return 0;
}

}  // extern "C"
