// The stationary covariance of kernel 1 (gp_predict.cu) and of its
// variants (gp_predict_variants.cu): the family switch, the squared
// scaled distance by per-dimension differences, and k_j scaled and masked.

#pragma once

#include "gp_predict_common.cuh"

namespace gp_common {

// The family, in the order of ops/gp_kernel.py's KINDS.
enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

template <typename T, int KIND>
__device__ __forceinline__ T covariance(T r2) {
  if (KIND == RBF) return cov_rbf(r2);
  if (KIND == MATERN12) return cov_matern12(r2);
  if (KIND == MATERN32) return cov_matern32(r2);
  return cov_matern52(r2);
}

// sum_c (xj_c - q_c)^2 for the query whose coordinates are qv (registers)
// and qrow (its row in memory). The first 4 dimensions (the pendulum's 3)
// are unrolled from registers; any further ones are read from the row.
template <typename T>
__device__ __forceinline__ T sq_dist(const T* xj, const T (&qv)[D_MAX],
                                     const T* __restrict__ qrow, int d) {
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
  return r2;
}

// k_j of that query, scaled and masked; x and mask in shared or global
// memory.
template <typename T, int KIND>
__device__ __forceinline__ T stationary_k(const T* x, const T* mask,
                                          const T (&qv)[D_MAX],
                                          const T* __restrict__ qrow, int d,
                                          T var_s2, int j) {
  return covariance<T, KIND>(sq_dist(x + (int64_t)j * d, qv, qrow, d)) *
         var_s2 * mask[j];
}

// Query row qi's coordinates in memory (a row past the ragged end reads
// the last query, as load_row does).
template <typename T>
__device__ __forceinline__ const T* query_row(const T* q, int64_t qi,
                                              int64_t n_q, int d) {
  return q + (qi < n_q ? qi : n_q - 1) * d;
}

}  // namespace gp_common
