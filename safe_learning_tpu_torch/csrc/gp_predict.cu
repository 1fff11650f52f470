// Fused GP posterior predict for a stationary kernel, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gp_predict_kernel`
// (safe_learning_tpu/ops/gp_kernel.py:169-214, entry `fused_gp_predict`).
// For every query q (row of `q`, already divided by the lengthscales):
//
//   k_j       = cov_kind(sum_d (x_jd - q_d)^2) * var_s2 * mask_j   (j < cap)
//   a         = chol_inv * k                  (chol_inv lower-triangular)
//   mean[q,:] = a^T alpha                     (p outputs)
//   var[q]    = sum_i a_i^2
//
// The (cap, Q) covariance never goes to device memory: each thread keeps
// its query's k in shared memory and its rows of a in registers, and
// writes only p + 1 numbers.
//
// What bounds it on the H100. At cap 128 a query costs about 3 * 128
// difference-FMAs and 128 exp for k, 128 * 129 / 2 ~ 8.3k FMAs for the
// triangular a = L^-1 k, and 128 * (p + 1) FMAs for the reductions, while
// it moves 20 bytes (3 coordinates in, 2 means and 1 variance out, f32).
// So it is bound by arithmetic and by the loads that feed the FMAs, not
// by device memory. The design for that (gp_predict_common.cuh):
//   - one query per thread; k (cap values per thread) is computed once
//     into shared memory when cap <= CB_MAX and read back conflict-free
//     (layout [j][thread]);
//   - a is produced RB rows at a time in registers. The block stages the
//     RB-row tile of chol_inv it needs in shared memory, transposed, so
//     each k_j feeds RB FMAs whose L^-1 operands arrive as broadcast
//     16-byte vector loads. Reading chol_inv through L1 instead took
//     12.6 ms against 3.3 ms at cap 128, Q = 10^6 on an H100 SXM at 700 W:
//     with 64 KB of k staged per block, L1 is too small to hold chol_inv;
//   - chol_inv is exactly lower-triangular (safe_learning_tpu/functions/
//     gp.py:687-688), so columns past a row block's last row are skipped;
//     inside the diagonal block the upper entries are exact zeros;
//   - above CB_MAX the k slice a row block needs is recomputed in chunks of
//     CB_MAX columns, so any cap (up to kernel_max_capacity = 2048) runs in
//     a fixed amount of shared memory.
// Padded rows count..cap of chol_inv are the identity with x = 0 there;
// the mask zeroes their k, hence their a, hence their share of var.
// No fast-math: exp is expf/exp, as the certificate margins measure the
// pipeline's rounding with the library exp.

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

template <typename T, int KIND>
__global__ void __launch_bounds__(NT)
gp_predict_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const T* __restrict__ chol_inv,
                  const T* __restrict__ alpha, const T* __restrict__ mask,
                  const T* __restrict__ var_s2_ptr, int64_t n_q, int d,
                  int cap, int p, int cb, T* __restrict__ mean_out,
                  T* __restrict__ var_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [cb][NT]: k per thread
  T* ls = ks + (int64_t)cb * NT;           // [cb][LS]: chol_inv tile^T

  T qv[D_MAX];
  int64_t qi;
  bool live;
  load_query(q, n_q, d, qv, qi, live);
  const T var_s2 = *var_s2_ptr;

  auto kfn = [&](int j) -> T {
    const T* xj = x + (int64_t)j * d;
    T r2 = T(0);
#pragma unroll
    for (int c = 0; c < D_MAX; ++c) {
      if (c < d) {
        T diff = __ldg(xj + c) - qv[c];
        r2 = r2 + diff * diff;
      }
    }
    return covariance<T, KIND>(r2) * var_s2 * __ldg(mask + j);
  };

  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);
  solve_and_reduce(ks, ls, kfn, chol_inv, alpha, cap, p, cb, macc, vacc);

  if (!live) return;
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) {
    if (c < p) mean_out[qi * p + c] = macc[c];
  }
  var_out[qi] = vacc;
}

template <typename T, int KIND>
cudaError_t launch_kind(const T* q, const T* x, const T* chol_inv,
                        const T* alpha, const T* mask, const T* var_s2,
                        int64_t n_q, int d, int cap, int p, T* mean_out,
                        T* var_out, cudaStream_t stream) {
  const int cb = cap < CB_MAX ? cap : CB_MAX;
  const size_t smem = smem_bytes<T>(cb);
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      gp_predict_kernel<T, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n_q + NT - 1) / NT;
  gp_predict_kernel<T, KIND><<<(unsigned)blocks, NT, smem, stream>>>(
      q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap, p, cb, mean_out,
      var_out);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* x, const void* chol_inv,
           const void* alpha, const void* mask, const void* var_s2,
           int64_t n_q, int d, int cap, int p, int kind, void* mean_out,
           void* var_out, void* stream) {
  if (n_q <= 0 || d < 1 || d > D_MAX || p < 1 || p > P_MAX || cap < 1 ||
      (n_q + NT - 1) / NT > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const T* q_ = static_cast<const T*>(q);
  const T* x_ = static_cast<const T*>(x);
  const T* l_ = static_cast<const T*>(chol_inv);
  const T* a_ = static_cast<const T*>(alpha);
  const T* m_ = static_cast<const T*>(mask);
  const T* v_ = static_cast<const T*>(var_s2);
  T* mo = static_cast<T*>(mean_out);
  T* vo = static_cast<T*>(var_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case RBF:
      return (int)launch_kind<T, RBF>(q_, x_, l_, a_, m_, v_, n_q, d, cap,
                                      p, mo, vo, s);
    case MATERN12:
      return (int)launch_kind<T, MATERN12>(q_, x_, l_, a_, m_, v_, n_q, d,
                                           cap, p, mo, vo, s);
    case MATERN32:
      return (int)launch_kind<T, MATERN32>(q_, x_, l_, a_, m_, v_, n_q, d,
                                           cap, p, mo, vo, s);
    case MATERN52:
      return (int)launch_kind<T, MATERN52>(q_, x_, l_, a_, m_, v_, n_q, d,
                                           cap, p, mo, vo, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Every pointer is a device pointer
// except `stream` (a cudaStream_t). Returns a cudaError_t; 0 is success.
extern "C" {

int gp_predict_f32(const void* q, const void* x, const void* chol_inv,
                   const void* alpha, const void* mask, const void* var_s2,
                   int64_t n_q, int d, int cap, int p, int kind,
                   void* mean_out, void* var_out, void* stream) {
  return launch<float>(q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap, p,
                       kind, mean_out, var_out, stream);
}

int gp_predict_f64(const void* q, const void* x, const void* chol_inv,
                   const void* alpha, const void* mask, const void* var_s2,
                   int64_t n_q, int d, int cap, int p, int kind,
                   void* mean_out, void* var_out, void* stream) {
  return launch<double>(q, x, chol_inv, alpha, mask, var_s2, n_q, d, cap, p,
                        kind, mean_out, var_out, stream);
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
