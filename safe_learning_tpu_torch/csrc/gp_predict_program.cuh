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
// ops/gp_kernel.py::render_program_source defines, in an anonymous
// namespace (each library's instantiations and their launch caches stay
// its own),
//
//   struct CovarianceProgram {
//     static constexpr int NUM_OUT, NUM_PARAMS, MIN_D;
//     template <typename T, int OUT> static T k(xj, q, pr, d);
//   };
//
// where k is output OUT's covariance between training row xj and query q
// (d input dimensions) as straight-line code over the parameters pr, and
// then invokes
// GP_PROGRAM_EXPORTS(CovarianceProgram). The program's structure is
// compiled in, as the Pallas kernels trace it statically
// (gp_kernel.py:220-222); the parameter values are a runtime array, so a
// new hyperparameter value needs no new build. For every query and every
// output s < S, over the n = count active rows:
//
//   k_j          = k_s(x_j, q) * s2 * mask_j     (j < n)
//   a            = chol_inv[s, :n, :n] * k
//   mean[q, s*p + c] = sum_i a_i alpha[s][i][c]  (c < p)
//   var[q, s]    = sum_i a_i^2
//
// What bounds it on the H100. The safe-learning loop calls it at cap 64
// with count 0 to 10, S = 2, on 3,003,501 grid points: per query and
// output about n (n + 1) / 2 solve FMAs and n evaluations of the program
// (the flagship's composite kernel: 3 products, a Matern sqrt and exp
// per row), against 28 bytes moved (3 coordinates in, 2 means and 2
// variances out). At count 10 that is about 39 us of FP32 work and 25 us
// of device memory on the whole grid, and looping to the capacity
// instead of the count would multiply 97 % of the solve's FMAs by exact
// zeros. The flagship (cap = count = 32) is FP32-bound the same way; at
// these counts evaluating the program costs more than the solve. The
// design is gp_predict_common.cuh's: loops stop at the count, a bucket
// NB >= count picks the tile shape at
// launch, chol_inv of all S outputs stays resident in shared memory where
// S * NB^2 fits in the block's budget (8 KB at the flagship, 0.8 KB in the
// safe-learning loop; else one output at a time, restaged per tile), and
// the solve is the register-tiled outer product. Per tile the outputs run
// back to back: each evaluates its program into the k tile, solves,
// reduces and stores; the parameters sit in registers (pr) for the whole
// block, and each input column is read and differenced once per row.
//
// Above count 128 the panel body runs (gp_program_panel; its design is in
// gp_predict_common.cuh). Any safe-exploration loop passes 128 data
// points after a few batches, and from then on every sweep, sampler step
// and refinement chunk goes through it: the adaptive example reaches count
// 181 with S = 2, where a query costs 2 x 16,471 solve FMAs, 362 program
// evaluations and 2 x 181 x 2 reduction FMAs, against 28 bytes. It is
// bound by FP32 FMAs fed from shared memory, at most about half the FP32
// rate with its 4 x 4 register tile (gp_predict_common.cuh). A block walks
// (query tile, output) items of a persistent grid: it evaluates the
// output's program into the K tile once, streams that output's chol_inv
// through the cp.async ring and reduces. The strip body (gp_program_strip)
// runs above panel_max<T>() rows (512 in float32, 256 in float64), or
// where a panel block does not fit, up to the 2,048 rows the GPs route to
// a kernel: a safe-exploration loop that runs longer than the adaptive
// example's 12 rounds passes those counts. The streamed body
// (solve_streamed) runs on no path; gp_program_streamed_* launch it at any
// count, for comparison. In float64 (the rigor paths) the tiled, panel
// and strip bodies run the product on the FP64 tensor cores
// (gp_program_tiled_dmma, gp_program_panel_dmma, gp_program_strip; the
// DMMA bodies of gp_predict_common.cuh), and the program's float64
// evaluation on the CUDA cores becomes the larger share.
// Numerics follow the plain twin (ops/gp_kernel.py::_eval_program):
// lengthscales enter as reciprocals multiplied into the differences, the
// program's k is scaled by s2 * mask afterwards, the 1e-36 guards of the
// covariance formulas are kept, and float32 and float64 share the code.
// No fast-math and no TF32.

#pragma once

#include <type_traits>

#include "gp_predict_common.cuh"

namespace gp_program {

using namespace gp_common;

constexpr int S_MAX = 8;        // most outputs (programs) per library
constexpr int PARAMS_MAX = 64;  // most program parameters (registers)

template <typename T>
struct Args {
  const T *q, *x, *params, *chol_inv, *alpha, *mask, *s2;
  int64_t n_q;
  int d, cap, n, p;
  T *mean_out, *var_out;
};

// Output OUT of one query tile, then the outputs after it. With
// `resident`, ls holds every output's chol_inv; else this stages OUT's.
template <typename T, class Prog, int NB, int OUT>
__device__ __forceinline__ void tile_outputs(
    const TiledSmem<T, NB>& sm, bool resident, const Args<T>& a,
    const T (&qv)[D_MAX], const T (&pr)[Prog::NUM_PARAMS], T s2,
    int64_t q0) {
  constexpr int LSZ = NB * ls_stride<T>(NB);
  if (!resident) {
    stage_chol_inv<T, NB>(sm.ls, a.chol_inv + (int64_t)OUT * a.cap * a.cap,
                          a.cap, a.n);
  }
  const T* xs = sm.xs;
  const T* ms = sm.ms;
  const int d = a.d;
  fill_k<T, NB>(sm.ks, [&](int j) {
    return Prog::template k<T, OUT>(xs + j * d, qv, pr, d) * s2 * ms[j];
  }, a.n);
  __syncthreads();  // k (and chol_inv) staged
  solve_tile<T, NB>(sm.ks, resident ? sm.ls + OUT * LSZ : sm.ls, sm.red,
                    a.alpha + (int64_t)OUT * a.cap * a.p, a.n, a.p);
  __syncthreads();  // partials written; k and chol_inv may be replaced
  store_tile<T, NB>(sm.red, q0, a.n_q, a.p, Prog::NUM_OUT, OUT, a.mean_out,
                    a.var_out);
  if constexpr (OUT + 1 < Prog::NUM_OUT) {
    tile_outputs<T, Prog, NB, OUT + 1>(sm, resident, a, qv, pr, s2, q0);
  }
}

template <typename T, class Prog>
__device__ __forceinline__ void load_params(const T* __restrict__ params,
                                            T (&pr)[Prog::NUM_PARAMS]) {
#pragma unroll
  for (int i = 0; i < Prog::NUM_PARAMS; ++i) pr[i] = __ldg(params + i);
}

// Output OUT of the float64 tiled body on DMMA over this block's query
// tiles (dmma_tiles), then the outputs after it. With `resident`, ls
// holds every output's chol_inv; else this stages OUT's.
template <class Prog, int NB, int OUT>
__device__ __forceinline__ void outputs_dmma(
    const TiledSmemD<NB>& sm, bool resident, const Args<double>& a,
    const double (&pr)[Prog::NUM_PARAMS], double s2) {
  using TL = TileD<NB>;
  constexpr int TQ = TL::TQ;
  if (!resident) {
    // The last output's solves were done with ls before its last barrier.
    stage_chol_inv_dmma<NB, TL::NTH>(
        sm.ls, a.chol_inv + (int64_t)OUT * a.cap * a.cap, a.cap, a.n);
  }
  const double* ls = resident ? sm.ls + OUT * dmma_tri(NB / 16) : sm.ls;
  const double* alpha = a.alpha + (int64_t)OUT * a.cap * a.p;
  auto q0_of = [&](int64_t u) { return (blockIdx.x + u * gridDim.x) * TQ; };
  dmma_tiles<NB>(
      block_items((a.n_q + TQ - 1) / TQ),
      [&](int64_t u, int b) {
        double qv[D_MAX];
        load_row(a.q, q0_of(u) + fill_tid<NB>() % TQ, a.n_q, a.d, qv);
        const double* xs = sm.xs;
        const double* ms = sm.ms;
        const int d = a.d;
        fill_tile_dmma<NB>(sm.ks(b), [&](int j) {
          return Prog::template k<double, OUT>(xs + j * d, qv, pr, d) * s2 *
                 ms[j];
        }, a.n);
      },
      [&](int64_t, int b) {
        solve_tile_dmma<NB>(sm.ks(b), ls, sm.red(b), alpha, a.n, a.p);
      },
      [&](int64_t u, int b) {
        store_slots<double, TQ, TL::WG, TL::NTH>(
            sm.red(b), q0_of(u), a.n_q, a.p, Prog::NUM_OUT, OUT, a.mean_out,
            a.var_out, (int)threadIdx.x);
      });
  if constexpr (OUT + 1 < Prog::NUM_OUT) {
    outputs_dmma<Prog, NB, OUT + 1>(sm, resident, a, pr, s2);
  }
}

// The float64 tiled body, bucket NB >= n: the product on DMMA
// (gp_predict_common.cuh's DMMA bodies). Bucket 192 is the panel body's
// up to 192 rows where its block fits (panel_resident).
template <typename T, class Prog, int NB>
__global__ void __launch_bounds__((tiled_threads<T, NB>()),
                                  (tiled_blocks<T, NB>()))
gp_program_tiled_dmma(const Args<T> a, bool resident) {
  static_assert(sizeof(T) == 8, "the DMMA body is float64");
  using TL = TileD<NB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledSmemD<NB> sm(smem_raw, resident ? Prog::NUM_OUT : 1, a.p, a.d);
  if (resident) {
    for (int s = 0; s < Prog::NUM_OUT; ++s) {
      stage_chol_inv_dmma<NB, TL::NTH>(
          sm.ls + s * dmma_tri(NB / 16),
          a.chol_inv + (int64_t)s * a.cap * a.cap, a.cap, a.n);
    }
  }
  stage_rows<T, TL::NTH>(sm.xs, sm.ms, a.x, a.mask, a.n, a.d);
  __syncthreads();  // x, the mask (and chol_inv) staged
  T pr[Prog::NUM_PARAMS];
  load_params<T, Prog>(a.params, pr);
  outputs_dmma<Prog, NB, 0>(sm, resident, a, pr, *a.s2);
}

// Tiled body, bucket NB >= n (gp_predict_common.cuh).
template <typename T, class Prog, int NB>
__global__ void __launch_bounds__(NT, (tiled_min_blocks<T, NB>()))
gp_program_tiled(const Args<T> a, bool resident) {
  constexpr int TQ = Tile<NB>::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TiledSmem<T, NB> sm(smem_raw, resident ? Prog::NUM_OUT : 1, a.p,
                            a.d);
  if (resident) {
    for (int s = 0; s < Prog::NUM_OUT; ++s) {
      stage_chol_inv<T, NB>(sm.ls + s * NB * ls_stride<T>(NB),
                            a.chol_inv + (int64_t)s * a.cap * a.cap, a.cap,
                            a.n);
    }
  }
  stage_rows(sm.xs, sm.ms, a.x, a.mask, a.n, a.d);
  __syncthreads();  // x and the mask staged
  T pr[Prog::NUM_PARAMS];
  load_params<T, Prog>(a.params, pr);
  const T s2 = *a.s2;
  const int64_t n_tiles = (a.n_q + TQ - 1) / TQ;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t q0 = t * TQ;
    T qv[D_MAX];
    load_row(a.q, q0 + threadIdx.x % TQ, a.n_q, a.d, qv);
    tile_outputs<T, Prog, NB, 0>(sm, resident, a, qv, pr, s2, q0);
  }
}

// Streamed body (n > panel_max<T>(), or gp_program_streamed_*): output
// OUT, then the outputs after it.
template <typename T, class Prog, int OUT>
__device__ __forceinline__ void streamed_outputs(
    T* ks, T* ls, const Args<T>& a, const T (&qv)[D_MAX],
    const T (&pr)[Prog::NUM_PARAMS], T s2, int64_t qi) {
  const T* __restrict__ x = a.x;
  const T* __restrict__ mask = a.mask;
  const int d = a.d;
  T macc[P_MAX];
#pragma unroll
  for (int c = 0; c < P_MAX; ++c) macc[c] = T(0);
  T vacc = T(0);
  solve_streamed(ks, ls, [&](int j) {
    return Prog::template k<T, OUT>(x + (int64_t)j * d, qv, pr, d) * s2 *
           mask[j];
  }, a.chol_inv + (int64_t)OUT * a.cap * a.cap,
     a.alpha + (int64_t)OUT * a.cap * a.p, a.cap, a.n, a.p, macc, vacc);
  if (qi < a.n_q) {
#pragma unroll
    for (int c = 0; c < P_MAX; ++c) {
      if (c < a.p) a.mean_out[(qi * Prog::NUM_OUT + OUT) * a.p + c] = macc[c];
    }
    a.var_out[qi * Prog::NUM_OUT + OUT] = vacc;
  }
  if constexpr (OUT + 1 < Prog::NUM_OUT) {
    streamed_outputs<T, Prog, OUT + 1>(ks, ls, a, qv, pr, s2, qi);
  }
}

template <typename T, class Prog>
__global__ void __launch_bounds__(NTS)
gp_program_streamed(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [CB][NTS]: k per thread
  T* ls = ks + (int64_t)CB * NTS;          // [CB][LS]: chol_inv tile^T
  const int64_t qi = (int64_t)blockIdx.x * NTS + threadIdx.x;
  T qv[D_MAX];
  load_row(a.q, qi, a.n_q, a.d, qv);
  T pr[Prog::NUM_PARAMS];
  load_params<T, Prog>(a.params, pr);
  streamed_outputs<T, Prog, 0>(ks, ls, a, qv, pr, *a.s2, qi);
}

template <typename T, class Prog>
cudaError_t launch_streamed(const Args<T>& a, cudaStream_t stream) {
  auto kernel = gp_program_streamed<T, Prog>;
  const size_t smem = streamed_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (a.n_q + NTS - 1) / NTS;
  kernel<<<(unsigned)blocks, NTS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Output s's K tile: the output's program at the staged rows and this
// thread's query (OUT runs through the outputs at compile time).
template <typename T, class Prog, int OUT = 0>
__device__ __forceinline__ void panel_fill(
    int s, T* ks, const T* xs, const T* ms, int n, int d,
    const T (&qv)[D_MAX], const T (&pr)[Prog::NUM_PARAMS], T s2) {
  if (s == OUT) {
    fill_k_rows<T, Panel<T>::TQ>(ks, [&](int j) {
      return Prog::template k<T, OUT>(xs + j * d, qv, pr, d) * s2 * ms[j];
    }, n);
  } else if constexpr (OUT + 1 < Prog::NUM_OUT) {
    panel_fill<T, Prog, OUT + 1>(s, ks, xs, ms, n, d, qv, pr, s2);
  }
}

// Output s's K tile for the float64 panel body on DMMA.
template <class Prog, int OUT = 0>
__device__ __forceinline__ void panel_fill_dmma(
    int s, double* ks, const double* xs, const double* ms, int n, int d,
    const double (&qv)[D_MAX], const double (&pr)[Prog::NUM_PARAMS],
    double s2) {
  if (s == OUT) {
    fill_k_dmma<PanelD::TQ, NT>(ks, [&](int j) {
      return Prog::template k<double, OUT>(xs + j * d, qv, pr, d) * s2 *
             ms[j];
    }, n, (int)threadIdx.x);
  } else if constexpr (OUT + 1 < Prog::NUM_OUT) {
    panel_fill_dmma<Prog, OUT + 1>(s, ks, xs, ms, n, d, qv, pr, s2);
  }
}

// The float64 panel body on DMMA (gp_predict_common.cuh), chol_inv
// streamed through the warps' rings: a persistent grid over (query tile,
// output) items.
template <typename T, class Prog>
__global__ void __launch_bounds__(NT, 1)
gp_program_panel_dmma(const Args<T> a) {
  static_assert(sizeof(T) == 8, "the DMMA body is float64");
  constexpr int TQ = PanelD::TQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rows = dmma_panel_rows(a.n);
  double* ks = reinterpret_cast<double*>(smem_raw);
  const int ksz = max(rows * TQ, NW * (a.p + 1) * TQ);
  double* ring = ks + ksz;
  double* xs = ring + NW * PanelD::NSLOT * PanelD::SLOT;
  double* ms = xs + rows * a.d;
  double* red = ks;  // the partial sums reuse the K tile's memory
  stage_rows(xs, ms, a.x, a.mask, a.n, a.d);
  double pr[Prog::NUM_PARAMS];
  load_params<double, Prog>(a.params, pr);
  const double s2 = *a.s2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned tiles = lpt_tiles(a.n, warp);
  double* wring = ring + warp * PanelD::NSLOT * PanelD::SLOT;
  const int64_t items = (a.n_q + TQ - 1) / TQ * Prog::NUM_OUT;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t q0 = it / Prog::NUM_OUT * TQ;
    const int s = (int)(it % Prog::NUM_OUT);
    const double* chol_inv = a.chol_inv + (int64_t)s * a.cap * a.cap;
    // The warp's first chunks are copied while the block evaluates k.
    WarpCursor ic(tiles, dmma_rows(a.n));
    for (int i = 0; i < PanelD::NSLOT - 1; ++i) {
      if (ic.valid()) {
        warp_fetch(wring + i * PanelD::SLOT, chol_inv, a.cap, a.n, ic, lane);
        ic.next();
      }
      cp_async_commit();
    }
    __syncthreads();  // x and the mask staged; the last item's red stored
    double qv[D_MAX];
    load_row(a.q, q0 + threadIdx.x % TQ, a.n_q, a.d, qv);
    panel_fill_dmma<Prog>(s, ks, xs, ms, a.n, a.d, qv, pr, s2);
    __syncthreads();  // K filled
    double part[P_MAX + 1][2];
    solve_panels_dmma(ks, wring, ic, tiles, chol_inv,
                      a.alpha + (int64_t)s * a.cap * a.p, a.cap, a.n, a.p,
                      lane, part);
    __syncthreads();  // every warp is done with K
    // The lanes of a query tile share its sums; the first stores them.
    constexpr int SB = share_bits<PanelD::QT>();
    double* mine = red + warp * (a.p + 1) * TQ +
                   8 * (lane >> 2 >> SB) + 2 * (lane & 3);
    if ((lane >> 2 & ((1 << SB) - 1)) == 0) {
#pragma unroll
      for (int c = 0; c <= P_MAX; ++c) {
        const int row = c == P_MAX ? a.p : c;
        if (c < a.p || c == P_MAX) {
          mine[row * TQ] = part[c][0];
          mine[row * TQ + 1] = part[c][1];
        }
      }
    }
    __syncthreads();  // partials written
    store_slots<double, TQ, NW, NT>(red, q0, a.n_q, a.p, Prog::NUM_OUT, s,
                                    a.mean_out, a.var_out, (int)threadIdx.x);
  }
  cp_async_wait<0>();
}

// Panel body (gp_predict_common.cuh): a persistent grid over (query tile,
// output) items.
template <typename T, class Prog>
__global__ void __launch_bounds__(NT, Panel<T>::MIN_BLOCKS)
gp_program_panel(const Args<T> a) {
  using P = Panel<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PanelSmem<T> sm(smem_raw, a.n, a.p, a.d);
  stage_rows(sm.xs, sm.ms, a.x, a.mask, a.n, a.d);
  T pr[Prog::NUM_PARAMS];
  load_params<T, Prog>(a.params, pr);
  const T s2 = *a.s2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rt = warp % P::RTP;
  const int qbase = warp / P::RTP * P::WTN + lane % WC * 4;
  const int64_t items = (a.n_q + P::TQ - 1) / P::TQ * Prog::NUM_OUT;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t q0 = it / Prog::NUM_OUT * P::TQ;
    const int s = (int)(it % Prog::NUM_OUT);
    const T* chol_inv = a.chol_inv + (int64_t)s * a.cap * a.cap;
    // The first tiles' copies run while the block evaluates k.
    PanelCursor<T> ic(a.n);
    for (int i = 0; i < P::NSLOT - 1; ++i) {
      if (ic.valid()) {
        panel_fetch(sm.ring + i * P::PROWS * P::LSTR, chol_inv, a.cap, ic);
        ic.next();
      }
      cp_async_commit();
    }
    __syncthreads();  // x and the mask staged (first item)
    T qv[D_MAX];
    load_row(a.q, q0 + threadIdx.x % P::TQ, a.n_q, a.d, qv);
    panel_fill<T, Prog>(s, sm.ks, sm.xs, sm.ms, a.n, a.d, qv, pr, s2);
    solve_panels(sm, ic, chol_inv, a.alpha + (int64_t)s * a.cap * a.p, a.cap,
                 a.n, a.p, rt, lane / WC, qbase);
    __syncthreads();  // partials written; K, the ring and red are free
    store_slots<T, P::TQ, P::RTP, NT>(sm.red, q0, a.n_q, a.p, Prog::NUM_OUT,
                                      s, a.mean_out, a.var_out,
                                      (int)threadIdx.x);
  }
}

// Output s's K rows jc0 .. jc0 + JC - 1 for the strip body: its program
// at the rows of x and this thread's query, whose coordinates (qv) and the
// parameters (pr) are read from shared memory (OUT runs through the
// outputs at compile time).
template <typename T, class Prog, int OUT = 0>
__device__ __forceinline__ void strip_fill_out(
    int s, T* kb, int jc0, const Args<T>& a, const T (&qv)[D_MAX],
    const T (&pr)[Prog::NUM_PARAMS], T s2) {
  if (s == OUT) {
    const T* __restrict__ x = a.x;
    const T* __restrict__ mask = a.mask;
    const int d = a.d;
    strip_fill(kb, [&](int j) {
      return Prog::template k<T, OUT>(x + (int64_t)j * d, qv, pr, d) * s2 *
             __ldg(mask + j);
    }, jc0, a.n);
  } else if constexpr (OUT + 1 < Prog::NUM_OUT) {
    strip_fill_out<T, Prog, OUT + 1>(s, kb, jc0, a, qv, pr, s2);
  }
}

// Dynamic shared memory of one strip block of a program: the body's and
// the parameters.
template <typename T, class Prog>
__host__ __device__ constexpr size_t strip_bytes(int p) {
  return strip_smem_bytes<T>(p) + sizeof(T) * Prog::NUM_PARAMS;
}

// The strip body (gp_predict_common.cuh), above the panel body's largest
// count: a persistent grid over (query tile, output) items, chol_inv and K
// streamed through shared memory by chunks.
template <typename T, class Prog>
__global__ void __launch_bounds__(Strip<T>::NTH, Strip<T>::BLOCKS)
gp_program_strip(const Args<T> a) {
  using S = Strip<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StripSmem<T> sm(smem_raw, a.p);
  for (int i = threadIdx.x; i < Prog::NUM_PARAMS; i += S::NTH) {
    sm.tail[i] = a.params[i];
  }
  const T(&pr)[Prog::NUM_PARAMS] =
      *reinterpret_cast<const T(*)[Prog::NUM_PARAMS]>(sm.tail);
  const T(&qv)[D_MAX] = *reinterpret_cast<const T(*)[D_MAX]>(
      sm.qs + threadIdx.x % S::TQ * QS_STRIDE);
  const T s2 = *a.s2;
  const int64_t items = (a.n_q + S::TQ - 1) / S::TQ * Prog::NUM_OUT;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t q0 = it / Prog::NUM_OUT * S::TQ;
    const int s = (int)(it % Prog::NUM_OUT);
    // The last item's fills are done (solve_strips ends in a barrier).
    strip_queries(sm.qs, a.q, q0, a.n_q, a.d);
    __syncthreads();  // the queries (and the parameters) staged
    solve_strips(sm.ring, sm.kbuf, sm.red, [&](T* kb, int jc0) {
      strip_fill_out<T, Prog>(s, kb, jc0, a, qv, pr, s2);
    }, a.chol_inv + (int64_t)s * a.cap * a.cap,
       a.alpha + (int64_t)s * a.cap * a.p, a.cap, a.n, a.p);
    store_slots<T, S::TQ, S::NWARP, S::NTH>(sm.red, q0, a.n_q, a.p,
                                            Prog::NUM_OUT, s, a.mean_out,
                                            a.var_out, (int)threadIdx.x);
  }
}

template <typename T, class Prog>
cudaError_t launch_strip(const Args<T>& a, cudaStream_t stream) {
  using S = Strip<T>;
  static GridCache cache;
  auto kernel = gp_program_strip<T, Prog>;
  const size_t smem = strip_bytes<T, Prog>(a.p);
  const int64_t items = (a.n_q + S::TQ - 1) / S::TQ * Prog::NUM_OUT;
  int grid = 0;
  const cudaError_t err =
      persistent_grid(cache, kernel, smem, items, 1, &grid, S::NTH);
  if (err != cudaSuccess) return err;
  kernel<<<grid, S::NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, class Prog>
cudaError_t launch_panel(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  // Float64 takes the DMMA body.
  auto kernel = [] {
    if constexpr (sizeof(T) == 8) {
      return gp_program_panel_dmma<T, Prog>;
    } else {
      return gp_program_panel<T, Prog>;
    }
  }();
  const size_t smem = panel_bytes<T>(a.n, a.p, a.d);
  const int64_t items =
      (a.n_q + panel_tq<T>() - 1) / panel_tq<T>() * Prog::NUM_OUT;
  int grid = 0;
  const cudaError_t err =
      persistent_grid(cache, kernel, smem, items, 1, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// How many outputs' chol_inv a tiled block at bucket NB holds: all S
// where they fit, else one (restaged per tile and output), else 0 (the
// block does not fit).
template <typename T, class Prog, int NB>
int resident_outputs(int p, int d) {
  if (tiled_smem_bytes<T, NB>(Prog::NUM_OUT, p, d) <= SMEM_MAX) {
    return Prog::NUM_OUT;
  }
  return tiled_smem_bytes<T, NB>(1, p, d) <= SMEM_MAX ? 1 : 0;
}

template <typename T, class Prog, int NB>
cudaError_t launch_tiled(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  // Float64 takes the DMMA body.
  auto kernel = [] {
    if constexpr (sizeof(T) == 8) {
      return gp_program_tiled_dmma<T, Prog, NB>;
    } else {
      return gp_program_tiled<T, Prog, NB>;
    }
  }();
  const int n_res = resident_outputs<T, Prog, NB>(a.p, a.d);
  const bool resident = n_res == Prog::NUM_OUT;
  const size_t smem = tiled_smem_bytes<T, NB>(n_res, a.p, a.d);
  constexpr int threads = tiled_threads<T, NB>();
  int grid = 0;
  const cudaError_t err = persistent_grid(cache, kernel, smem, a.n_q,
                                          tiled_tq<T, NB>(), &grid, threads);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a, resident);
  return cudaGetLastError();
}

// Whether a float64 panel launch at count rows keeps chol_inv resident:
// the warp-specialised tiled body at bucket 192, where its block fits.
template <typename T, class Prog>
bool panel_resident(int count, int p, int d) {
  if constexpr (sizeof(T) == 8) {
    return count <= 192 && resident_outputs<double, Prog, 192>(p, d) > 0;
  } else {
    return false;
  }
}

// f(std::integral_constant<int, NB>{}) at the tiled bucket NB >= count
// (count <= N_TILED_MAX).
template <class F>
decltype(auto) with_bucket(int count, F&& f) {
  if (count <= 16) return f(std::integral_constant<int, 16>{});
  if (count <= 32) return f(std::integral_constant<int, 32>{});
  if (count <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, N_TILED_MAX>{});
}

// The body a launch takes, from its shape alone: the tiled body up to
// N_TILED_MAX rows where its block fits, else the panel body up to
// panel_max<T>() rows where its block fits, else the strip body, at any
// count (its block fits at every p and d). In float64, BODY_PANEL from 129
// to 192 rows launches the resident tiled body at bucket 192
// (gp_program_tiled_dmma, panel_resident) where its block fits, else
// gp_program_panel_dmma: both are the DMMA bodies that serve the panel's
// range. No launch takes the streamed body: only gp_program_streamed_*
// reach it, for comparisons.
enum Body { BODY_TILED = 0, BODY_PANEL = 1, BODY_STRIP = 2,
            BODY_STREAMED = 3 };

static_assert(strip_smem_bytes<double>(P_MAX) +
                      sizeof(double) * PARAMS_MAX <= SMEM_MAX,
              "the strip block fits at every p");

// The body above the tiled body's range (kernel 1 takes it from 129 rows).
template <typename T, class Prog>
Body wide_body(int count, int p, int d) {
  if (count <= panel_max<T>() &&
      (panel_resident<T, Prog>(count, p, d) ||
       panel_bytes<T>(count, p, d) <= SMEM_MAX)) {
    return BODY_PANEL;
  }
  return BODY_STRIP;
}

template <typename T, class Prog>
Body body(int count, int p, int d) {
  if (count <= N_TILED_MAX &&
      with_bucket(count, [&](auto nb) {
        return resident_outputs<T, Prog, decltype(nb)::value>(p, d);
      }) > 0) {
    return BODY_TILED;
  }
  return wide_body<T, Prog>(count, p, d);
}

// Launch wide_body's b, BODY_PANEL or BODY_STRIP.
template <typename T, class Prog>
int launch_wide(Body b, const Args<T>& a, cudaStream_t st) {
  if (b == BODY_STRIP) return (int)launch_strip<T, Prog>(a, st);
  if constexpr (sizeof(T) == 8) {
    if (panel_resident<T, Prog>(a.n, a.p, a.d)) {
      return (int)launch_tiled<T, Prog, 192>(a, st);
    }
  }
  return (int)launch_panel<T, Prog>(a, st);
}

// The launch arguments, or cudaErrorInvalidValue for arguments the
// library does not take.
template <typename T, class Prog>
cudaError_t make_args(const void* q, const void* x, const void* params,
                      const void* chol_inv, const void* alpha,
                      const void* mask, const void* s2, int64_t n_q, int d,
                      int cap, int count, int p, void* mean_out,
                      void* var_out, Args<T>* a) {
  static_assert(Prog::NUM_OUT >= 1 && Prog::NUM_OUT <= S_MAX,
                "program library output count");
  static_assert(Prog::NUM_PARAMS >= 1 && Prog::NUM_PARAMS <= PARAMS_MAX,
                "program library parameter count");
  if (n_q <= 0 || d < Prog::MIN_D || d > D_MAX || p < 1 || p > P_MAX ||
      cap < 1 || count < 0 || count > cap ||
      (n_q + NTS - 1) / NTS > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  *a = Args<T>{static_cast<const T*>(q), static_cast<const T*>(x),
               static_cast<const T*>(params),
               static_cast<const T*>(chol_inv),
               static_cast<const T*>(alpha), static_cast<const T*>(mask),
               static_cast<const T*>(s2), n_q, d, cap, count, p,
               static_cast<T*>(mean_out), static_cast<T*>(var_out)};
  return cudaSuccess;
}

template <typename T, class Prog>
int launch(const void* q, const void* x, const void* params,
           const void* chol_inv, const void* alpha, const void* mask,
           const void* s2, int64_t n_q, int d, int cap, int count, int p,
           void* mean_out, void* var_out, void* stream) {
  Args<T> a;
  const cudaError_t err =
      make_args<T, Prog>(q, x, params, chol_inv, alpha, mask, s2, n_q, d,
                         cap, count, p, mean_out, var_out, &a);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Body b = body<T, Prog>(count, p, d);
  if (b == BODY_TILED) {
    return with_bucket(count, [&](auto nb) {
      return (int)launch_tiled<T, Prog, decltype(nb)::value>(a, st);
    });
  }
  return launch_wide<T, Prog>(b, a, st);
}

// The streamed body at any count, for comparisons with the body a launch
// takes; no path of the package launches it.
template <typename T, class Prog>
int launch_streamed_entry(const void* q, const void* x, const void* params,
                          const void* chol_inv, const void* alpha,
                          const void* mask, const void* s2, int64_t n_q,
                          int d, int cap, int count, int p, void* mean_out,
                          void* var_out, void* stream) {
  Args<T> a;
  const cudaError_t err =
      make_args<T, Prog>(q, x, params, chol_inv, alpha, mask, s2, n_q, d,
                         cap, count, p, mean_out, var_out, &a);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_streamed<T, Prog>(a, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block at a count (see launch).
template <typename T, class Prog>
long long smem_bytes(int count, int p, int d) {
  switch (body<T, Prog>(count, p, d)) {
    case BODY_TILED:
      return with_bucket(count, [&](auto nb) {
        constexpr int NB = decltype(nb)::value;
        return (long long)tiled_smem_bytes<T, NB>(
            resident_outputs<T, Prog, NB>(p, d), p, d);
      });
    case BODY_PANEL:
      if constexpr (sizeof(T) == 8) {
        if (panel_resident<T, Prog>(count, p, d)) {
          return (long long)tiled_smem_bytes<T, 192>(
              resident_outputs<T, Prog, 192>(p, d), p, d);
        }
      }
      return (long long)panel_bytes<T>(count, p, d);
    case BODY_STRIP:
      return (long long)strip_bytes<T, Prog>(p);
    default:
      return (long long)streamed_smem_bytes<T>();
  }
}

}  // namespace gp_program

// Plain C interface of one program library, bound with ctypes. Every
// pointer is a device pointer except `stream` (a cudaStream_t); chol_inv
// is [S][cap][cap], alpha [S][cap][p], mean_out [Q][S * p], var_out
// [Q][S]; `count` is the number of active rows (0 <= count <= cap).
// Returns a cudaError_t; 0 is success. gp_program_streamed_* take the same
// arguments and launch the streamed body whatever the count.
// gp_program_smem_bytes is the dynamic shared memory of one block at a
// count, p and d, gp_program_body the body a launch takes there (0 tiled,
// 1 panel, 2 strip) and gp_program_panel_max the largest count of the
// panel body; they are introspection only.
#define GP_PROGRAM_ENTRY(NAME, FN, T, PROG)                                 \
  int NAME(const void* q, const void* x, const void* params,               \
           const void* chol_inv, const void* alpha, const void* mask,      \
           const void* s2, int64_t n_q, int d, int cap, int count, int p,  \
           void* mean_out, void* var_out, void* stream) {                  \
    return gp_program::FN<T, PROG>(q, x, params, chol_inv, alpha, mask,    \
                                   s2, n_q, d, cap, count, p, mean_out,    \
                                   var_out, stream);                       \
  }

#define GP_PROGRAM_EXPORTS(PROG)                                            \
  extern "C" {                                                              \
  GP_PROGRAM_ENTRY(gp_program_f32, launch, float, PROG)                     \
  GP_PROGRAM_ENTRY(gp_program_f64, launch, double, PROG)                    \
  GP_PROGRAM_ENTRY(gp_program_streamed_f32, launch_streamed_entry, float,   \
                   PROG)                                                    \
  GP_PROGRAM_ENTRY(gp_program_streamed_f64, launch_streamed_entry, double,  \
                   PROG)                                                    \
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
  long long gp_program_smem_bytes(int count, int itemsize, int p, int d) {  \
    return itemsize == 8                                                    \
               ? gp_program::smem_bytes<double, PROG>(count, p, d)          \
               : gp_program::smem_bytes<float, PROG>(count, p, d);          \
  }                                                                         \
  int gp_program_body(int count, int itemsize, int p, int d) {              \
    return itemsize == 8 ? gp_program::body<double, PROG>(count, p, d)      \
                         : gp_program::body<float, PROG>(count, p, d);      \
  }                                                                         \
  int gp_program_panel_max(int itemsize) {                                  \
    return itemsize == 8 ? gp_common::panel_max<double>()                   \
                         : gp_common::panel_max<float>();                   \
  }                                                                         \
  }
