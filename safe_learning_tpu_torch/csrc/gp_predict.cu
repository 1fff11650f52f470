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
// n = 128 the streamed body recomputes k in chunks, so any count up to
// kernel_max_capacity = 2048 runs in a fixed amount of shared memory.
//
// Padded rows count..cap of chol_inv are the identity with x = 0 there;
// the mask zeroes their k, hence their a: the loops stop at the count and
// skip only exact zeros. No fast-math: exp is expf/exp, as the
// certificate margins measure the pipeline's rounding with the library
// exp.

#include "gp_predict_common.cuh"

namespace {

using namespace gp_common;

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

template <typename T, int KIND>
__device__ __forceinline__ T covariance(T r2) {
  if (KIND == RBF) return cov_rbf(r2);
  if (KIND == MATERN12) return cov_matern12(r2);
  if (KIND == MATERN32) return cov_matern32(r2);
  return cov_matern52(r2);
}

// k_j of the query whose coordinates are qv (registers) and qrow (its
// row in memory), scaled and masked; x and mask in shared or global
// memory. The first 4 dimensions (the pendulum's 3) are unrolled from
// registers; any further ones are read from the row.
template <typename T, int KIND>
__device__ __forceinline__ T stationary_k(const T* x, const T* mask,
                                          const T (&qv)[D_MAX],
                                          const T* __restrict__ qrow, int d,
                                          T var_s2, int j) {
  const T* xj = x + (int64_t)j * d;
  T r2 = T(0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < d) {
      T diff = xj[c] - qv[c];
      r2 = r2 + diff * diff;
    }
  }
  for (int c = 4; c < d; ++c) {
    T diff = xj[c] - qrow[c];
    r2 = r2 + diff * diff;
  }
  return covariance<T, KIND>(r2) * var_s2 * mask[j];
}

// Query row qi's coordinates in memory (a row past the ragged end reads
// the last query, as load_row does).
template <typename T>
__device__ __forceinline__ const T* query_row(const T* q, int64_t qi,
                                              int64_t n_q, int d) {
  return q + (qi < n_q ? qi : n_q - 1) * d;
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

// Streamed body, n > N_TILED_MAX: one query per thread.
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
  auto kernel = gp_predict_tiled<T, KIND, NB>;
  const size_t smem = tiled_smem_bytes<T, NB>(1, a.p, a.d);
  // Too many outputs or dimensions for a resident chol_inv (float64 at
  // bucket 128): the streamed body takes it.
  if (smem > SMEM_MAX) return launch_streamed<T, KIND>(a);
  int grid = 0;
  const cudaError_t err =
      persistent_grid(cache, kernel, smem, a.n_q, Tile<NB>::TQ, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, a.stream>>>(a.q, a.x, a.chol_inv, a.alpha,
                                       a.mask, a.var_s2, a.n_q, a.d, a.cap,
                                       a.n, a.p, a.mean_out, a.var_out);
  return cudaGetLastError();
}

// The bucket of the count: the smallest NB >= n, or the streamed body.
template <typename T, int KIND>
cudaError_t launch_kind(const Args<T>& a) {
  if (a.n <= 16) return launch_tiled<T, KIND, 16>(a);
  if (a.n <= 32) return launch_tiled<T, KIND, 32>(a);
  if (a.n <= 64) return launch_tiled<T, KIND, 64>(a);
  if (a.n <= N_TILED_MAX) return launch_tiled<T, KIND, N_TILED_MAX>(a);
  return launch_streamed<T, KIND>(a);
}

template <typename T>
int launch(const void* q, const void* x, const void* chol_inv,
           const void* alpha, const void* mask, const void* var_s2,
           int64_t n_q, int d, int cap, int count, int p, int kind,
           void* mean_out, void* var_out, void* stream) {
  if (n_q <= 0 || d < 1 || d > D_MAX || p < 1 || p > P_MAX || cap < 1 ||
      count < 0 || count > cap || (n_q + NTS - 1) / NTS > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(x),
                  static_cast<const T*>(chol_inv),
                  static_cast<const T*>(alpha), static_cast<const T*>(mask),
                  static_cast<const T*>(var_s2), n_q, d, cap, count, p,
                  static_cast<T*>(mean_out), static_cast<T*>(var_out),
                  static_cast<cudaStream_t>(stream)};
  switch (kind) {
    case RBF:
      return (int)launch_kind<T, RBF>(a);
    case MATERN12:
      return (int)launch_kind<T, MATERN12>(a);
    case MATERN32:
      return (int)launch_kind<T, MATERN32>(a);
    case MATERN52:
      return (int)launch_kind<T, MATERN52>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer
// except `stream` (a cudaStream_t). `count` is the number of active rows
// (0 <= count <= cap; see the precondition in ops/gp_kernel.py). Returns
// a cudaError_t; 0 is success.
extern "C" {

int gp_predict_f32(const void* q, const void* x, const void* chol_inv,
                   const void* alpha, const void* mask, const void* var_s2,
                   int64_t n_q, int d, int cap, int count, int p, int kind,
                   void* mean_out, void* var_out, void* stream) {
  return launch<float>(q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap,
                       count, p, kind, mean_out, var_out, stream);
}

int gp_predict_f64(const void* q, const void* x, const void* chol_inv,
                   const void* alpha, const void* mask, const void* var_s2,
                   int64_t n_q, int d, int cap, int count, int p, int kind,
                   void* mean_out, void* var_out, void* stream) {
  return launch<double>(q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap,
                        count, p, kind, mean_out, var_out, stream);
}

const char* gp_predict_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int gp_predict_limits(int* d_max, int* p_max) {
  *d_max = D_MAX;
  *p_max = P_MAX;
  return 0;
}

}  // extern "C"
