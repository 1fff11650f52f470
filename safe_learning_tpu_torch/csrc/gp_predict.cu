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
// by device memory. The design for that:
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;      // threads (queries) per block
constexpr int RB = 32;       // rows of a held in registers at a time
constexpr int CB_MAX = 128;  // k columns staged in shared memory
constexpr int D_MAX = 16;    // largest input dimension
constexpr int P_MAX = 8;     // largest number of outputs

enum Kind { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// The formulas of STATIONARY_COVARIANCES (functions/gp.py), 1e-36 guards
// included.
template <typename T, int KIND>
__device__ __forceinline__ T covariance(T r2) {
  if (KIND == RBF) {
    return dev_exp(T(-0.5) * r2);
  } else if (KIND == MATERN12) {
    return dev_exp(-dev_sqrt(r2 + T(1e-36)));
  } else if (KIND == MATERN32) {
    T r = dev_sqrt(T(3) * r2 + T(1e-36));
    return (T(1) + r) * dev_exp(-r);
  } else {
    T r = dev_sqrt(T(5) * r2 + T(1e-36));
    return (T(1) + r + r * r / T(3)) * dev_exp(-r);
  }
}

// k_j for j in [j0, j0 + jn) of this thread's query, into ks[(j - j0)][tid].
template <typename T, int KIND>
__device__ __forceinline__ void compute_k(T* ks, const T* __restrict__ x,
                                          const T* __restrict__ mask,
                                          const T (&qv)[D_MAX], int d,
                                          T var_s2, int j0, int jn) {
  for (int j = 0; j < jn; ++j) {
    const T* xj = x + (int64_t)(j0 + j) * d;
    T r2 = T(0);
#pragma unroll
    for (int c = 0; c < D_MAX; ++c) {
      if (c < d) {
        T diff = __ldg(xj + c) - qv[c];
        r2 = r2 + diff * diff;
      }
    }
    ks[j * NT + threadIdx.x] =
        covariance<T, KIND>(r2) * var_s2 * __ldg(mask + j0 + j);
  }
}

// Row stride of the staged chol_inv tile: RB values plus 16 bytes, so a
// column of the tile is one run of 16-byte-aligned vector loads and the
// transposing stores spread over several banks.
template <typename T>
__host__ __device__ constexpr int tile_stride() {
  return RB + 16 / (int)sizeof(T);
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

template <typename T, int KIND>
__global__ void __launch_bounds__(NT)
gp_predict_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const T* __restrict__ chol_inv,
                  const T* __restrict__ alpha, const T* __restrict__ mask,
                  const T* __restrict__ var_s2_ptr, int64_t n_q, int d,
                  int cap, int p, int cb, T* __restrict__ mean_out,
                  T* __restrict__ var_out) {
  using V = typename Vec16<T>::type;
  constexpr int LS = tile_stride<T>();
  constexpr int VN = 16 / (int)sizeof(T);  // lanes per vector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [cb][NT]: k per thread
  T* ls = ks + (int64_t)cb * NT;           // [cb][LS]: chol_inv tile^T

  const int tid = threadIdx.x;
  const int64_t qi = (int64_t)blockIdx.x * NT + tid;
  const bool live = qi < n_q;
  // Threads past the ragged end compute on the last query and store
  // nothing: every thread takes part in staging the shared tiles.
  const int64_t qrow = live ? qi : n_q - 1;
  const T var_s2 = *var_s2_ptr;

  T qv[D_MAX];
#pragma unroll
  for (int c = 0; c < D_MAX; ++c) qv[c] = c < d ? q[qrow * d + c] : T(0);

  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);

  const bool staged = cap <= cb;
  if (staged) compute_k<T, KIND>(ks, x, mask, qv, d, var_s2, 0, cap);

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
      if (!staged) compute_k<T, KIND>(ks, x, mask, qv, d, var_s2, j0, jn);
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
  const size_t smem = (size_t)cb * (NT + tile_stride<T>()) * sizeof(T);
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
