// Shared body of the fused GP-predict kernels for Hopper (sm_90a).
//
// Both kernels, the stationary one (gp_predict.cu) and the covariance-
// program one (gp_predict_program.cuh), compute for every query q and
// every output
//
//   k_j       = k(x_j, q) * scale^2 * mask_j            (j < cap)
//   a         = chol_inv * k                  (chol_inv lower-triangular)
//   mean[q,:] += a^T alpha                    (p outputs)
//   var[q]    += sum_i a_i^2
//
// and differ only in how k(x_j, q) is formed. This header holds what they
// share: the covariance formulas, the per-thread staging of k, the
// transposed chol_inv tile and the triangular solve with its reductions
// (solve_and_reduce). The design and what bounds it on the H100 are in
// gp_predict.cu's header.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gp_common {

constexpr int NT = 128;      // threads (queries) per block
constexpr int RB = 32;       // rows of a held in registers at a time
constexpr int CB_MAX = 128;  // k columns staged in shared memory
constexpr int D_MAX = 16;    // largest input dimension
constexpr int P_MAX = 8;     // largest number of outputs of one GP

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

// Row stride of the staged chol_inv tile: RB values plus 16 bytes, so a
// column of the tile is one run of 16-byte-aligned vector loads and the
// transposing stores spread over several banks.
template <typename T>
__host__ __device__ constexpr int tile_stride() {
  return RB + 16 / (int)sizeof(T);
}

// Dynamic shared memory of one block: k for NT queries and the chol_inv
// tile, cb columns each.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int cb) {
  return (size_t)cb * (NT + tile_stride<T>()) * sizeof(T);
}

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

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

// One output of one query per thread: a = chol_inv * k, then
// macc[c] += sum_i a_i alpha[i, c] and vacc += sum_i a_i^2.
//
// kfn(j) returns this thread's k_j, already scaled and masked. ks is the
// block's [cb][NT] k buffer, ls its [cb][tile_stride] chol_inv tile.
// With cap <= cb, k is computed once into shared memory; above, the k
// slice a row block needs is recomputed in chunks of cb columns, so any
// cap runs in a fixed amount of shared memory. Every thread of the block
// must call this (it synchronises the block to stage the tiles).
template <typename T, class KFn>
__device__ __forceinline__ void solve_and_reduce(
    T* ks, T* ls, const KFn& kfn, const T* __restrict__ chol_inv,
    const T* __restrict__ alpha, int cap, int p, int cb,
    T (&macc)[P_MAX], T& vacc) {
  using V = typename Vec16<T>::type;
  constexpr int LS = tile_stride<T>();
  constexpr int VN = 16 / (int)sizeof(T);  // lanes per vector
  const int tid = threadIdx.x;

  const bool staged = cap <= cb;
  if (staged) {
    for (int j = 0; j < cap; ++j) ks[j * NT + tid] = kfn(j);
  }

  for (int r0 = 0; r0 < cap; r0 += RB) {
    const int nr = min(RB, cap - r0);
    const int row_end = r0 + nr;
    T acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = T(0);

    // Columns 0 .. row_end-1: everything right of the block is zero.
    for (int j0 = 0; j0 < row_end; j0 += cb) {
      const int jn = min(cb, row_end - j0);
      __syncthreads();  // the previous tile has been read
      // Stage rows r0..r0+RB, columns j0..j0+jn of chol_inv, transposed
      // (ls[j][r]); reads along a row are coalesced, rows past cap are 0.
      for (int idx = tid; idx < RB * jn; idx += NT) {
        const int r = idx / jn;
        const int j = idx - r * jn;
        ls[j * LS + r] =
            r < nr ? chol_inv[(int64_t)(r0 + r) * cap + j0 + j] : T(0);
      }
      if (!staged) {
        for (int j = 0; j < jn; ++j) ks[j * NT + tid] = kfn(j0 + j);
      }
      __syncthreads();

      const T* kcol = staged ? ks + (int64_t)j0 * NT : ks;
      for (int j = 0; j < jn; ++j) {
        const T kj = kcol[j * NT + tid];
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

// This thread's query, its first d coordinates in registers. Threads past
// the ragged end compute on the last query and store nothing: every
// thread takes part in staging the shared tiles.
template <typename T>
__device__ __forceinline__ void load_query(const T* __restrict__ q,
                                           int64_t n_q, int d,
                                           T (&qv)[D_MAX], int64_t& qi,
                                           bool& live) {
  qi = (int64_t)blockIdx.x * NT + threadIdx.x;
  live = qi < n_q;
  const int64_t qrow = live ? qi : n_q - 1;
#pragma unroll
  for (int c = 0; c < D_MAX; ++c) qv[c] = c < d ? q[qrow * d + c] : T(0);
}

}  // namespace gp_common
