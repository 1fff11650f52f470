// Fused GP posterior predict for covariance programs, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of safe_learning_tpu/ops/gp_kernel.py:
//   - `_gp_predict_kernel_general` (:271-295, entry
//     `fused_gp_predict_general`): one GP whose kernel is a compiled
//     composite program (ARD stationary, linear, ActiveDims, sums,
//     products) on unscaled inputs, p outputs sharing that kernel;
//   - `_gp_predict_kernel_stacked` (:347-383, entry
//     `fused_gp_predict_stacked`): S single-output GPs over one training
//     set, each with its own program, chol_inv and alpha, in one launch.
// One template serves both. A source file rendered by
// ops/gp_kernel.py::render_program_source defines
//
//   struct CovarianceProgram {
//     static constexpr int NUM_OUT, NUM_PARAMS, MIN_D;
//     template <typename T, int OUT> static T k(xj, q, pr);
//   };
//
// where k is output OUT's covariance between training row xj and query q
// as straight-line code over the parameter registers pr, and then invokes
// GP_PROGRAM_EXPORTS(CovarianceProgram). The program's structure is
// compiled in, as the Pallas kernels trace it statically
// (gp_kernel.py:220-222); the parameter values are a runtime array, so a
// new hyperparameter value needs no new build. For every query and every
// output s < S:
//
//   k_j          = k_s(x_j, q) * s2 * mask_j     (j < cap)
//   a            = chol_inv[s] * k
//   mean[q, s*p + c] = sum_i a_i alpha[s][i][c]  (c < p)
//   var[q, s]    = sum_i a_i^2
//
// What bounds it on the H100. As for the stationary kernel
// (gp_predict.cu's header), the triangular solve a = L^-1 k dominates:
// cap (cap + 1) / 2 FMAs per query and output against a few dozen for
// the program (the flagship's composite kernel: 3 products and a Matern
// exp per j), while a query moves (d + 2 S) values. So it is bound by
// arithmetic and the loads feeding the FMAs, not by device memory. The
// design carries gp_predict.cu's over (solve_and_reduce in
// gp_predict_common.cuh: one query per thread, k staged per thread in
// shared memory, the chol_inv row tile staged transposed, the triangular
// skip, chunked k above cap 128, ragged Q computed on the last query and
// not stored). What is new:
//   - the program's parameters are loaded once per thread into registers
//     (pr), and each input column is read and differenced once per j;
//   - the S outputs run back to back through the same shared buffers.
//     Keeping k of all outputs at once would cost S * cap * NT values
//     (128 KB at cap 128, S = 2, f32) beside the chol_inv tile; instead
//     each output recomputes its differences and products (d = 3: a few
//     FMAs), which on the GPU is a register and L1 matter, not HBM
//     traffic as on the TPU.
// Numerics follow the plain twin (ops/gp_kernel.py::_eval_program):
// lengthscales enter as reciprocals multiplied into the differences, the
// program's k is scaled by s2 * mask afterwards, the 1e-36 guards of the
// covariance formulas are kept, and float32 and float64 share the code.
// No fast-math and no TF32.

#pragma once

#include "gp_predict_common.cuh"

namespace gp_program {

using namespace gp_common;

constexpr int S_MAX = 8;        // most outputs (programs) per library
constexpr int PARAMS_MAX = 64;  // most program parameters (registers)

// Output OUT, then the outputs after it.
template <typename T, class Prog, int OUT>
__device__ __forceinline__ void run_outputs(
    T* ks, T* ls, const T* __restrict__ x, const T* __restrict__ chol_inv,
    const T* __restrict__ alpha, const T* __restrict__ mask,
    const T (&qv)[D_MAX], const T (&pr)[Prog::NUM_PARAMS], int d, int cap,
    int p, int cb, T s2, bool live, int64_t qi, T* __restrict__ mean_out,
    T* __restrict__ var_out) {
  auto kfn = [&](int j) -> T {
    const T* xj = x + (int64_t)j * d;
    return Prog::template k<T, OUT>(xj, qv, pr) * s2 * __ldg(mask + j);
  };
  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);
  solve_and_reduce(ks, ls, kfn, chol_inv + (int64_t)OUT * cap * cap,
                   alpha + (int64_t)OUT * cap * p, cap, p, cb, macc, vacc);
  if (live) {
#pragma unroll
    for (int c = 0; c < P_MAX; ++c) {
      if (c < p) mean_out[(qi * Prog::NUM_OUT + OUT) * p + c] = macc[c];
    }
    var_out[qi * Prog::NUM_OUT + OUT] = vacc;
  }
  if constexpr (OUT + 1 < Prog::NUM_OUT) {
    run_outputs<T, Prog, OUT + 1>(ks, ls, x, chol_inv, alpha, mask, qv, pr,
                                  d, cap, p, cb, s2, live, qi, mean_out,
                                  var_out);
  }
}

template <typename T, class Prog>
__global__ void __launch_bounds__(NT)
gp_program_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const T* __restrict__ params,
                  const T* __restrict__ chol_inv,
                  const T* __restrict__ alpha, const T* __restrict__ mask,
                  const T* __restrict__ s2_ptr, int64_t n_q, int d, int cap,
                  int p, int cb, T* __restrict__ mean_out,
                  T* __restrict__ var_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [cb][NT]: k per thread
  T* ls = ks + (int64_t)cb * NT;           // [cb][LS]: chol_inv tile^T

  T qv[D_MAX];
  int64_t qi;
  bool live;
  load_query(q, n_q, d, qv, qi, live);
  const T s2 = *s2_ptr;
  T pr[Prog::NUM_PARAMS];
#pragma unroll
  for (int i = 0; i < Prog::NUM_PARAMS; ++i) pr[i] = __ldg(params + i);

  run_outputs<T, Prog, 0>(ks, ls, x, chol_inv, alpha, mask, qv, pr, d, cap,
                          p, cb, s2, live, qi, mean_out, var_out);
}

template <typename T, class Prog>
int launch(const void* q, const void* x, const void* params,
           const void* chol_inv, const void* alpha, const void* mask,
           const void* s2, int64_t n_q, int d, int cap, int p,
           void* mean_out, void* var_out, void* stream) {
  static_assert(Prog::NUM_OUT >= 1 && Prog::NUM_OUT <= S_MAX,
                "program library output count");
  static_assert(Prog::NUM_PARAMS >= 1 && Prog::NUM_PARAMS <= PARAMS_MAX,
                "program library parameter count");
  if (n_q <= 0 || d < Prog::MIN_D || d > D_MAX || p < 1 || p > P_MAX ||
      cap < 1 || (n_q + NT - 1) / NT > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int cb = cap < CB_MAX ? cap : CB_MAX;
  const size_t smem = smem_bytes<T>(cb);
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      gp_program_kernel<T, Prog>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_q + NT - 1) / NT;
  gp_program_kernel<T, Prog><<<(unsigned)blocks, NT, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<const T*>(params), static_cast<const T*>(chol_inv),
      static_cast<const T*>(alpha), static_cast<const T*>(mask),
      static_cast<const T*>(s2), n_q, d, cap, p, cb,
      static_cast<T*>(mean_out), static_cast<T*>(var_out));
  return (int)cudaGetLastError();
}

}  // namespace gp_program

// Plain C interface of one program library, bound with ctypes. Every
// pointer is a device pointer except `stream` (a cudaStream_t); chol_inv
// is [S][cap][cap], alpha [S][cap][p], mean_out [Q][S * p], var_out
// [Q][S]. Returns a cudaError_t; 0 is success. gp_program_smem_bytes is
// the dynamic shared memory of one block at a capacity.
#define GP_PROGRAM_EXPORTS(PROG)                                            \
  extern "C" {                                                              \
  int gp_program_f32(const void* q, const void* x, const void* params,     \
                     const void* chol_inv, const void* alpha,               \
                     const void* mask, const void* s2, int64_t n_q, int d,  \
                     int cap, int p, void* mean_out, void* var_out,         \
                     void* stream) {                                        \
    return gp_program::launch<float, PROG>(q, x, params, chol_inv, alpha,  \
                                           mask, s2, n_q, d, cap, p,        \
                                           mean_out, var_out, stream);      \
  }                                                                         \
  int gp_program_f64(const void* q, const void* x, const void* params,     \
                     const void* chol_inv, const void* alpha,               \
                     const void* mask, const void* s2, int64_t n_q, int d,  \
                     int cap, int p, void* mean_out, void* var_out,         \
                     void* stream) {                                        \
    return gp_program::launch<double, PROG>(q, x, params, chol_inv, alpha, \
                                            mask, s2, n_q, d, cap, p,       \
                                            mean_out, var_out, stream);     \
  }                                                                         \
  const char* gp_program_error_string(int err) {                            \
    return cudaGetErrorString(static_cast<cudaError_t>(err));               \
  }                                                                         \
  int gp_program_limits(int* d_max, int* p_max, int* num_out,               \
                        int* num_params, int* min_d) {                      \
    *d_max = gp_common::D_MAX;                                              \
    *p_max = gp_common::P_MAX;                                              \
    *num_out = PROG::NUM_OUT;                                               \
    *num_params = PROG::NUM_PARAMS;                                         \
    *min_d = PROG::MIN_D;                                                   \
    return 0;                                                               \
  }                                                                         \
  long long gp_program_smem_bytes(int cap, int itemsize) {                  \
    const int cb = cap < gp_common::CB_MAX ? cap : gp_common::CB_MAX;       \
    return itemsize == 8 ? (long long)gp_common::smem_bytes<double>(cb)     \
                         : (long long)gp_common::smem_bytes<float>(cb);     \
  }                                                                         \
  }
