// Fused GP posterior predict for a stationary kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gp_predict_kernel`
// (safe_learning_tpu/ops/gp_kernel.py:169-214, entry `fused_gp_predict`).
// For every query q (row of `q`, already divided by the lengthscales),
// over the n = count active rows:
//
//   k_j       = cov_kind(sum_d (x_jd - q_d)^2) * var_s2 * mask_j   (j < n)
//   a         = chol_inv[:n, :n] * k          (chol_inv lower-triangular)
//   mean[q,:] = a^T alpha[:n]                 (p outputs)
//   var[q]    = sum_i a_i^2
//
// The (n, Q) covariance never goes to device memory: a block keeps one
// tile of it in shared memory and writes only p + 1 numbers per query.
//
// What bounds it on the H100. At the bench's n = 128, p = 2 a query costs
// 8,256 FMAs for a = L^-1 k, about 1.3k operations for k (3 differences,
// 3 FMAs and an expf per row) and 384 FMAs for the reductions, while it
// moves 20 bytes (3 coordinates in, 2 means and 1 variance out, f32):
// bound by FP32 arithmetic on the CUDA cores (about 0.28 ms at 10^6
// queries against 67 TFLOP/s), not by device memory (about 6 us). What
// the design does about it is in gp_predict_common.cuh: loops bounded by
// the count, chol_inv resident in shared memory on a persistent grid, a
// register-tiled outer product fed by 16-byte shared-memory vectors, and
// a fused epilogue. The dimension loop of k is unrolled over the first 4
// dimensions from registers and runs on from memory past them. Above
// n = 128 kernel 1 takes the bodies kernels 2 and 3 take there, by shape
// alone (body): the panel body up to panel_max<T>() rows and the strip
// body above it, up to kernel_max_capacity = 2048, through
// StationaryProgram, the stationary covariance as a one-output program of
// gp_predict_program.cuh whose parameter is the family; gp_predict_body
// reports the body of a shape.
// The streamed body stays behind gp_predict_streamed_*, for comparisons.
// In float64 (the extended check of the bench) the tiled body runs the
// product on the FP64 tensor cores (gp_predict_common.cuh's DMMA bodies):
// the float64 exp of the k fill on the CUDA cores is then the larger
// share, and two blocks an SM overlap one's fill with the other's solve.
//
// Padded rows count..cap of chol_inv are the identity with x = 0 there;
// the mask zeroes their k, hence their a: the loops stop at the count and
// skip only exact zeros. No fast-math: exp is expf/exp, as the
// certificate margins measure the pipeline's rounding with the library
// exp.

#include "gp_predict_program.cuh"
#include "gp_predict_stationary.cuh"

namespace {

using namespace gp_common;

// Kernel 1's covariance as a one-output program of gp_predict_program.cuh,
// so that the panel and strip bodies serve kernel 1 as they serve kernels 2
// and 3: the squared scaled distance over the d dimensions, summed from
// the first as stationary_k does, then the family, whose code (KINDS) is
// the program's one parameter: one instantiation of each wide body serves
// the four families, a branch every warp takes alike. The caller scales
// by var_s2 and masks.
struct StationaryProgram {
  static constexpr int NUM_OUT = 1;
  static constexpr int NUM_PARAMS = 1;
  static constexpr int MIN_D = 1;
  template <typename T, int OUT>
  static __device__ __forceinline__ T k(const T* xj, const T (&q)[D_MAX],
                                        const T (&pr)[NUM_PARAMS], int d) {
    T r2 = T(0);
#pragma unroll
    for (int c = 0; c < D_MAX; ++c) {
      if (c < d) {
        T diff = xj[c] - q[c];
        r2 = r2 + diff * diff;
      }
    }
    switch ((int)pr[0]) {
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
};

// The family codes as program parameters on the device, one a family.
__device__ const float kKindCodes32[4] = {0.f, 1.f, 2.f, 3.f};
__device__ const double kKindCodes64[4] = {0.0, 1.0, 2.0, 3.0};

// The address of family `kind`'s code in dtype T on the current device.
template <typename T>
cudaError_t kind_code(int kind, const T** code) {
  void* ptr = nullptr;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = cudaGetSymbolAddress(&ptr, kKindCodes32);
  } else {
    err = cudaGetSymbolAddress(&ptr, kKindCodes64);
  }
  *code = static_cast<const T*>(ptr) + kind;
  return err;
}

// Tiled body, bucket NB >= n (gp_predict_common.cuh).
template <typename T, int KIND, int NB>
__global__ void __launch_bounds__(NT, (tiled_min_blocks<T, NB>()))
gp_predict_tiled(const T* __restrict__ q, const T* __restrict__ x,
                 const T* __restrict__ chol_inv,
                 const T* __restrict__ alpha, const T* __restrict__ mask,
                 const T* __restrict__ var_s2_ptr, int64_t n_q, int d,
                 int cap, int n, int p, T* __restrict__ mean_out,
                 T* __restrict__ var_out) {
  constexpr int TQ = Tile<NB>::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledSmem<T, NB> sm(smem_raw, 1, p, d);

  stage_chol_inv<T, NB>(sm.ls, chol_inv, cap, n);
  stage_rows(sm.xs, sm.ms, x, mask, n, d);
  __syncthreads();  // x and the mask staged
  const T var_s2 = *var_s2_ptr;
  const int64_t n_tiles = (n_q + TQ - 1) / TQ;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t q0 = t * TQ;
    const int64_t qi = q0 + threadIdx.x % TQ;
    T qv[D_MAX];
    load_row(q, qi, n_q, d, qv);
    const T* qrow = query_row(q, qi, n_q, d);
    fill_k<T, NB>(sm.ks, [&](int j) {
      return stationary_k<T, KIND>(sm.xs, sm.ms, qv, qrow, d, var_s2, j);
    }, n);
    __syncthreads();  // k staged
    solve_tile<T, NB>(sm.ks, sm.ls, sm.red, alpha, n, p);
    __syncthreads();  // partials written; k may be overwritten
    store_tile<T, NB>(sm.red, q0, n_q, p, 1, 0, mean_out, var_out);
  }
}

// The float64 tiled body, bucket NB >= n: the product on DMMA
// (gp_predict_common.cuh's DMMA bodies).
template <typename T, int KIND, int NB>
__global__ void __launch_bounds__((tiled_threads<T, NB>()),
                                  (tiled_blocks<T, NB>()))
gp_predict_tiled_dmma(const T* __restrict__ q, const T* __restrict__ x,
                      const T* __restrict__ chol_inv,
                      const T* __restrict__ alpha,
                      const T* __restrict__ mask,
                      const T* __restrict__ var_s2_ptr, int64_t n_q, int d,
                      int cap, int n, int p, T* __restrict__ mean_out,
                      T* __restrict__ var_out) {
  static_assert(sizeof(T) == 8, "the DMMA body is float64");
  using TL = TileD<NB>;
  constexpr int TQ = TL::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledSmemD<NB> sm(smem_raw, 1, p, d);
  stage_chol_inv_dmma<NB, TL::NTH>(sm.ls, chol_inv, cap, n);
  stage_rows<T, TL::NTH>(sm.xs, sm.ms, x, mask, n, d);
  __syncthreads();  // chol_inv, x and the mask staged
  const T var_s2 = *var_s2_ptr;
  auto q0_of = [&](int64_t u) { return (blockIdx.x + u * gridDim.x) * TQ; };
  dmma_tiles<NB>(
      block_items((n_q + TQ - 1) / TQ),
      [&](int64_t u, int b) {
        const int64_t qi = q0_of(u) + fill_tid<NB>() % TQ;
        T qv[D_MAX];
        load_row(q, qi, n_q, d, qv);
        const T* qrow = query_row(q, qi, n_q, d);
        fill_tile_dmma<NB>(sm.ks(b), [&](int j) {
          return stationary_k<T, KIND>(sm.xs, sm.ms, qv, qrow, d, var_s2, j);
        }, n);
      },
      [&](int64_t, int b) {
        solve_tile_dmma<NB>(sm.ks(b), sm.ls, sm.red(b), alpha, n, p);
      },
      [&](int64_t u, int b) {
        store_slots<T, TQ, TL::WG, TL::NTH>(sm.red(b), q0_of(u), n_q, p, 1,
                                            0, mean_out, var_out,
                                            (int)threadIdx.x);
      });
}

// Streamed body, one query per thread: the comparison entries
// gp_predict_streamed_* alone launch it.
template <typename T, int KIND>
__global__ void __launch_bounds__(NTS)
gp_predict_streamed(const T* __restrict__ q, const T* __restrict__ x,
                    const T* __restrict__ chol_inv,
                    const T* __restrict__ alpha, const T* __restrict__ mask,
                    const T* __restrict__ var_s2_ptr, int64_t n_q, int d,
                    int cap, int n, int p, T* __restrict__ mean_out,
                    T* __restrict__ var_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [CB][NTS]: k per thread
  T* ls = ks + (int64_t)CB * NTS;          // [CB][LS]: chol_inv tile^T

  const int64_t qi = (int64_t)blockIdx.x * NTS + threadIdx.x;
  T qv[D_MAX];
  load_row(q, qi, n_q, d, qv);
  const T* qrow = query_row(q, qi, n_q, d);
  const T var_s2 = *var_s2_ptr;

  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);
  solve_streamed(ks, ls, [&](int j) {
    return stationary_k<T, KIND>(x, mask, qv, qrow, d, var_s2, j);
  }, chol_inv, alpha, cap, n, p, macc, vacc);

  if (qi >= n_q) return;
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) {
    if (c < p) mean_out[qi * p + c] = macc[c];
  }
  var_out[qi] = vacc;
}

template <typename T>
struct Args {
  const T *q, *x, *chol_inv, *alpha, *mask, *var_s2;
  int64_t n_q;
  int d, cap, n, p;
  T *mean_out, *var_out;
  cudaStream_t stream;
};

template <typename T, int KIND>
cudaError_t launch_streamed(const Args<T>& a) {
  auto kernel = gp_predict_streamed<T, KIND>;
  const size_t smem = streamed_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (a.n_q + NTS - 1) / NTS;
  kernel<<<(unsigned)blocks, NTS, smem, a.stream>>>(
      a.q, a.x, a.chol_inv, a.alpha, a.mask, a.var_s2, a.n_q, a.d, a.cap,
      a.n, a.p, a.mean_out, a.var_out);
  return cudaGetLastError();
}

template <typename T, int KIND, int NB>
cudaError_t launch_tiled(const Args<T>& a) {
  static GridCache cache;
  // Float64 takes the DMMA body.
  auto kernel = [] {
    if constexpr (sizeof(T) == 8) {
      return gp_predict_tiled_dmma<T, KIND, NB>;
    } else {
      return gp_predict_tiled<T, KIND, NB>;
    }
  }();
  const size_t smem = tiled_smem_bytes<T, NB>(1, a.p, a.d);
  constexpr int threads = tiled_threads<T, NB>();
  int grid = 0;
  const cudaError_t err = persistent_grid(cache, kernel, smem, a.n_q,
                                          tiled_tq<T, NB>(), &grid, threads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, a.stream>>>(a.q, a.x, a.chol_inv, a.alpha,
                                       a.mask, a.var_s2, a.n_q, a.d, a.cap,
                                       a.n, a.p, a.mean_out, a.var_out);
  return cudaGetLastError();
}

// The body kernel 1 takes, by shape alone: the tiled body up to
// N_TILED_MAX rows where its block fits (every block at D_MAX and P_MAX
// does), else the body kernels 2 and 3 take there (gp_program::wide_body:
// the panel body up to panel_max<T>() rows, the strip body above).
template <typename T>
gp_program::Body body(int count, int p, int d) {
  if (count <= N_TILED_MAX &&
      gp_program::with_bucket(count, [&](auto nb) {
        return tiled_smem_bytes<T, decltype(nb)::value>(1, p, d);
      }) <= SMEM_MAX) {
    return gp_program::BODY_TILED;
  }
  return gp_program::wide_body<T, StationaryProgram>(count, p, d);
}

// Launch the tiled body at the bucket NB >= n, or the streamed body, of
// kind KIND.
template <typename T, int KIND>
cudaError_t launch_kind(const Args<T>& a, gp_program::Body b) {
  if (b == gp_program::BODY_STREAMED) return launch_streamed<T, KIND>(a);
  return gp_program::with_bucket(a.n, [&](auto nb) {
    return launch_tiled<T, KIND, decltype(nb)::value>(a);
  });
}

// streamed: the streamed body whatever the count (the comparison entry),
// else the body of the shape.
template <typename T>
int launch(const void* q, const void* x, const void* chol_inv,
           const void* alpha, const void* mask, const void* var_s2,
           int64_t n_q, int d, int cap, int count, int p, int kind,
           void* mean_out, void* var_out, void* stream, bool streamed) {
  if (n_q <= 0 || d < 1 || d > D_MAX || p < 1 || p > P_MAX || cap < 1 ||
      count < 0 || count > cap || (n_q + NTS - 1) / NTS > 0x7fffffffLL ||
      kind < RBF || kind > MATERN52) {
    return (int)cudaErrorInvalidValue;
  }
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(x),
                  static_cast<const T*>(chol_inv),
                  static_cast<const T*>(alpha), static_cast<const T*>(mask),
                  static_cast<const T*>(var_s2), n_q, d, cap, count, p,
                  static_cast<T*>(mean_out), static_cast<T*>(var_out),
                  static_cast<cudaStream_t>(stream)};
  const gp_program::Body b =
      streamed ? gp_program::BODY_STREAMED : body<T>(count, p, d);
  if (b == gp_program::BODY_PANEL || b == gp_program::BODY_STRIP) {
    const T* code = nullptr;
    const cudaError_t err = kind_code<T>(kind, &code);
    if (err != cudaSuccess) return (int)err;
    const gp_program::Args<T> pa{a.q,    a.x,    code,   a.chol_inv,
                                 a.alpha, a.mask, a.var_s2, a.n_q,
                                 a.d,    a.cap,  a.n,    a.p,
                                 a.mean_out, a.var_out};
    return gp_program::launch_wide<T, StationaryProgram>(b, pa, a.stream);
  }
  switch (kind) {
    case RBF:
      return (int)launch_kind<T, RBF>(a, b);
    case MATERN12:
      return (int)launch_kind<T, MATERN12>(a, b);
    case MATERN32:
      return (int)launch_kind<T, MATERN32>(a, b);
    default:
      return (int)launch_kind<T, MATERN52>(a, b);
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer
// except `stream` (a cudaStream_t). `count` is the number of active rows
// (0 <= count <= cap; see the precondition in ops/gp_kernel.py). Returns
// a cudaError_t; 0 is success. gp_predict_streamed_* take the same
// arguments and launch the streamed body whatever the count, for
// comparisons; gp_predict_body is the body a launch takes at a count,
// item size, p and d (0 tiled, 1 panel, 2 strip), introspection only.
extern "C" {

#define GP_PREDICT_ENTRY(NAME, T, STREAMED)                                 \
  int NAME(const void* q, const void* x, const void* chol_inv,             \
           const void* alpha, const void* mask, const void* var_s2,        \
           int64_t n_q, int d, int cap, int count, int p, int kind,        \
           void* mean_out, void* var_out, void* stream) {                  \
    return launch<T>(q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap,     \
                     count, p, kind, mean_out, var_out, stream, STREAMED); \
  }

GP_PREDICT_ENTRY(gp_predict_f32, float, false)
GP_PREDICT_ENTRY(gp_predict_f64, double, false)
GP_PREDICT_ENTRY(gp_predict_streamed_f32, float, true)
GP_PREDICT_ENTRY(gp_predict_streamed_f64, double, true)

const char* gp_predict_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gp_predict_limits(int* d_max, int* p_max) {
  *d_max = D_MAX;
  *p_max = P_MAX;
  return 0;
}

int gp_predict_body(int count, int itemsize, int p, int d) {
  return itemsize == 8 ? body<double>(count, p, d) : body<float>(count, p, d);
}

}  // extern "C"
