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
// the product L^-1 K (n (n + 1) / 2 FMAs a query) fed from shared memory,
// and the n covariances of k, never device memory. Each variant asks one
// question about kernel 1's tiled body (fill k, barrier, solve, barrier,
// store, per query tile):
//
//   - pipelined: the k fill overlapped with the solve. In float32 (the
//     tiled body of tiled_pipelined_ws) by warp specialisation: one solve
//     warpgroup and two fill warpgroups a block, one block an SM with
//     chol_inv resident (transposed) beside a ring of NS = 2 K slots of
//     128 queries; the fill warps hand each slot over by a full mbarrier
//     and take it back by an empty one, so they run a tile ahead and no
//     block-wide barrier stops the solve. The fill warps give up registers
//     (setmaxnreg.dec) and the solve warps take them (setmaxnreg.inc):
//     each solve thread holds an 8 x 8 register tile (8 rows, 8 queries),
//     64 FMAs per four 16-byte shared loads where kernel 1's 4 x 4 tile
//     issues 16 per two, which halves the shared traffic per FMA that
//     bounds kernel 1's solve. A solve warp is 2 row lanes x 16 query
//     lanes (16 rows x 128 queries) and takes the row tiles g and 7 - g,
//     so its four warps do the same work; each a_i accumulates over j
//     from 0 in kernel 1's order, so A is kernel 1's bit for bit and only
//     the reductions' tree differs. In float64 (tiled_pipelined): the k
//     tile and the partial sums are doubled into two slots;
//     in iteration t a block solves tile t from one slot and builds tile
//     t+1's k into the other, one barrier a tile.
//   - interleaved<H>, H in {2, 4}: on the TPU, H sub-tiles a tile, each
//     sub-tile's covariance -> matmul chain independent of the others, so
//     the compiler interleaves one chain's exp with another's matmul in
//     one instruction stream. A GPU warp issues in order; the warp
//     schedulers interleave warps. So in float32 (tiled_interleaved_chains)
//     each chain is a warpgroup of its own: one persistent block an SM
//     stages chol_inv (transposed), x and the mask once behind the block's
//     only barrier, then each of its H warpgroups walks its own sequence of
//     query tiles (the block's tiles g, g + H, ...) and per tile fills its
//     own K slot (kernel 1's stationary_k, one or two threads a query),
//     syncs on its own named barrier (bar.sync 1 + g, 128), solves with
//     kernel 4's solve rows (ws_rows: row tiles w and 7 - w a warp, both
//     held in registers, each a_i over j from 0 in kernel 1's order, so A
//     is kernel 1's bit for bit and only the reductions' tree differs),
//     syncs, writes its partial sums over its K slot (ws_part), syncs,
//     stores and syncs again. No barrier spans two chains, so the chains
//     drift out of phase and one chain's exp (MUFU) issues beside
//     another's shared loads and FMAs; the block holds one chol_inv
//     (67,584 B) where kernel 1's two blocks an SM hold two, and no room
//     for partial sums, so it fits at every p and d. What bounds it is the
//     SM's issue rate: about 9,216 FMAs and 576 shared loads a query for
//     the solve (16-row tiles) plus about 20 instructions a covariance.
//     Its shape per H: at H = 2, 8 x 8 register tiles (64 FMAs per four
//     16-byte loads) and 128-query tiles (64 KB a K slot, 255 registers a
//     thread, 8 warps); at H = 4, 8 x 4 tiles and 64-query tiles (32 KB,
//     128 registers, 16 warps, kernel 1's warp count with one chol_inv).
//     In float64 (tiled_interleaved) a block takes
//     H tiles at a time; each sub-tile builds its k and runs its solve,
//     and sub-tile h+1's build follows sub-tile h's solve with no barrier
//     between (the k tile is a ring of two slots; every sub-tile has its
//     own partial sums, stored after the group's last barrier): H + 1
//     barriers for H tiles.
//   - folded: k is the bare cov_kind(r2); the wrapper has folded
//     var_s2 * mask into the columns of chol_inv once per call, as the JAX
//     wrapper does outside its body. Two multiplies less per (row, query)
//     in the fill; on kernel 1's schedule (float64, tiled_serial) the fill
//     is not what bounds it, the FP32 solve is. So in float32
//     (tiled_folded_tf32) the product runs on the tensor cores in three
//     TF32 passes with kernel 7's solve warpgroups, ring and epilogue
//     (tf32_block, tf32_solve; the folded chol_inv's TF32 halves in
//     registers), and the fill, which then sets the pace, is kernel 1's
//     per-dimension r2 (no cancellation near r2 = 0, unlike the expanded
//     form) on the CUDA cores: x transposed in shared memory, read 4 rows
//     a 16-byte broadcast, the query's coordinates in registers (a tile
//     ahead), the covariance, the TF32 split and two 16-byte stores per 4
//     rows (folded_fill). Rows from the count to the solve's last k step
//     must be exact zeros (0 * NaN is NaN on the tensor cores; kernel 7
//     gets them from var_s2 mask_j = 0): the block zeroes both K slots
//     once and the fill's loop stops at the count, so no element pays for
//     the count or the mask. Not IEEE float32: chip_smoke.folded_bounds,
//     with tf32x3.
//   - expanded: r2 = max(xx_j - 2 x_j.q + qq, 0), xx_j and qq in the
//     working precision on the CUDA cores. On the TPU both of the JAX
//     kernel's products, the cross term x^T q and L^-1 K, run on the
//     matrix unit; in float32 (the tiled body of tiled_expanded_tf32)
//     both run on the tensor cores in three TF32 passes: each operand v
//     is split into big = cvt.rna.tf32(v) and small = cvt.rna.tf32(v -
//     big), and small.big + big.small, then big.big, go into one FP32
//     accumulator (495 TFLOP/s of TF32 is about 165 effective, against 67
//     of FP32). Two solve warpgroups hold chol_inv's rows 0-63 and 64-127
//     as the register A operand of wgmma (m64n64k8, split into TF32
//     halves once a block: 64 and 128 registers a thread; the triangle
//     above each warpgroup's last row is never read, a quarter of the k
//     steps); K's halves are the B operand in shared memory, a ring of
//     NS = 2 slots of 64 queries (68 KB each). Two fill warpgroups form
//     the cross term q x^T of rows 0-63 and 64-127 the same way
//     (m64n64k8, the queries' halves from registers, loaded a tile ahead,
//     x's staged in shared memory once a block), take r2, the covariance
//     and var_s2 mask_j from the accumulator fragments, split k and store
//     both halves into the slot, two rows at a time; full and empty
//     mbarriers hand the slots over. Registers move from the fill
//     warpgroups to the solve warpgroup of rows 64-127 (setmaxnreg). The
//     epilogue sums alpha^T a and a^2 from the accumulator fragments by
//     shuffles (reduce_tiles), then over the 8 solve warps in shared
//     memory. Three TF32 passes are not IEEE float32: the split leaves
//     about 2^-22 of each operand, the tensor cores' sums are not
//     documented as rounded to nearest (chip_smoke.expanded_bounds, with
//     tf32x3, bounds both), and the kernel stays off every path. In
//     float64 the expanded form runs on the CUDA cores (tiled_serial),
//     never TF32. The expanded form cancels near r2 = 0
//     (the clamp keeps r2 >= 0).
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
// the streamed body (kernel 7's float32 tiled body also takes the depth
// of its cross term, 8 or 16, as a template parameter): 28 kernels where
// one per family would be 68, which keeps the library's build near
// kernel 1's. float32 blocks are one an SM: the pipelined body 384
// threads, the interleaved 128 a chain, the folded and expanded 512;
// float64 blocks have 256 threads (kernel 1's), the pipelined and
// interleaved 128, whose tile is 32 queries wide, so that chol_inv (128 KB
// in float64) and two k slots fit in the 227 KB a block may use. Loops
// are bounded by the host's count, padded rows are exact zeros
// (gp_predict.cu), no fast-math.

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

// Kernel 1's schedule with the k form KF (folded, expanded; float64): per
// tile, build, barrier, solve, barrier, store.
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

// The float64 interleaved schedule: HS consecutive tiles a group. Sub-tile
// h's solve is followed by sub-tile h+1's build (k slots alternate) with
// no barrier between; each sub-tile has its own partials, stored after the
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

// ---------------------------------------------------------------------------
// Hopper primitives of the float32 bodies below
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase after `count`
// arrivals.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Barrier `id` (1-15) over `threads` threads of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// Shared-memory writes by this thread visible to the tensor cores' reads
// (the async proxy), before the barrier that hands them over.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Registers a thread of this warpgroup may hold (sm_90a). The counts of a
// block's warpgroups, times 128, must fit the SM's 65,536: an increase
// the pool cannot grant waits forever.
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The float32 v as TF32, rounded to nearest (ties away), and the TF32
// of what it leaves: v = big + small + O(2^-22 |v|).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// Shared-memory matrix descriptor of wgmma, no swizzle (K-major): 8 x 16-
// byte core matrices, `kstride` bytes apart along K (the leading byte
// offset), `nstride` bytes apart along M or N (the stride byte offset).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p,
                                               uint32_t kstride,
                                               uint32_t nstride) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(kstride >> 4) << 16) |
         ((uint64_t)(nstride >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulators as written by the wgmma just waited for: no access the
// compiler moves to before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 of a warpgroup, fp32) += A B in TF32: A (64 x 8) from
// registers, a[0..3] = A[16w + g][t], A[16w + g + 8][t], A[16w + g][t + 4],
// A[16w + g + 8][t + 4] (warp w, lane (g, t) = (lane / 4, lane % 4)); B
// (8 x 64) by descriptor; d[4c + 2h + e] = D[16w + g + 8h][8c + 2t + e].
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// Kernel 7's float32 tiled body: the expanded form on the tensor cores in
// three TF32 passes (its design is in the header note)
// ---------------------------------------------------------------------------
struct Tf32 {
  static constexpr int TQ = 64;    // queries a tile
  static constexpr int NS = 2;     // K slots in the ring
  static constexpr int NTH = 512;  // 2 solve and 2 fill warpgroups
  // A K half ([128 j][64 q] as TF32, K-major for wgmma): core matrices of
  // 8 queries x 4 rows (128 bytes), the 8 query groups of 4 rows together,
  // KSTR bytes per 4 rows. The 64 bytes past 1024 put the two 4-row groups
  // of a half-warp's 8-byte fill stores on other banks.
  static constexpr int KSTR = 1088;
  static constexpr int HALF = NBV / 4 * KSTR;
  static constexpr int SLOT = 2 * HALF;  // big, then small
  // x's TF32 halves as the cross term's B operand ([128 j][16 dims],
  // K-major): the 16 row groups of 128 bytes per 4 dimensions.
  static constexpr int XSTR = NBV / 8 * 128;
  static constexpr int XHALF = 4 * XSTR;
  // Partial sums a tile: [2 buffers][8 warps][p + 1][TQ].
  static __host__ __device__ constexpr int red_floats(int p) {
    return 2 * 8 * (p + 1) * TQ;
  }
  static __host__ __device__ constexpr size_t bytes(int p) {
    return (size_t)NS * SLOT + 2 * XHALF +
           sizeof(float) * ((size_t)red_floats(p) + 2 * NBV) +
           2 * NS * sizeof(uint64_t);
  }
};

// Pointers into its shared memory.
struct Tf32Smem {
  uint64_t *full, *empty;
  unsigned char *slots, *xop;
  float *red, *xx, *vm;
  __device__ __forceinline__ Tf32Smem(unsigned char* raw, int p) {
    slots = raw;
    xop = slots + Tf32::NS * Tf32::SLOT;
    red = reinterpret_cast<float*>(xop + 2 * Tf32::XHALF);
    xx = red + Tf32::red_floats(p);
    vm = xx + NBV;
    full = reinterpret_cast<uint64_t*>(vm + NBV);
    empty = full + Tf32::NS;
  }
};

// Solve warpgroup MT: rows 64 MT .. 64 MT + 63 of A = L^-1 K, for every
// query tile of the block. chol_inv's rows stay in registers, split into
// TF32 halves, for the whole run: KS = 8 (MT + 1) k steps of 8 columns
// (the triangle above row 64 MT + 63 is never read). Per tile: the two
// small passes over every k step, then big x big, into one FP32
// accumulator; then alpha^T a and sum a^2 of its rows by shuffles into
// its warps' partial sums.
template <int MT>
__device__ __forceinline__ void tf32_solve(const Tf32Smem& sm,
                                           const Args<float>& a,
                                           int64_t items) {
  constexpr int KS = 8 * (MT + 1);
  const int tid = threadIdx.x - 128 * MT;
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n = a.n, p = a.p;
  const int i0 = 64 * MT + 16 * w + g;  // this lane's rows: i0, i0 + 8
  uint32_t lb[KS][4], ls[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 8 * (r & 1), j = 8 * s + t + 4 * (r >> 1);
      const float v =
          i < n && j < n ? __ldg(a.chol_inv + (int64_t)i * a.cap + j) : 0.f;
      split_tf32(v, lb[s][r], ls[s][r]);
    }
  }
  // Its k steps at this count: rows 0-63 to min(n, 64), rows 64-127 to n.
  const int lim = MT == 0 ? min(n, 64) : (n > 64 ? n : 0);
  const int steps = (lim + 7) / 8;
  for (int64_t u = 0; u < items; ++u) {
    const int s = (int)(u % Tf32::NS);
    mbar_wait(sm.full + s, (unsigned)(u / Tf32::NS) & 1u);
    const unsigned char* kb = sm.slots + s * Tf32::SLOT;
    const uint64_t big = wgmma_desc(kb, Tf32::KSTR, 128);
    const uint64_t small = wgmma_desc(kb + Tf32::HALF, Tf32::KSTR, 128);
    // One k step is two 4-row groups: 2 KSTR bytes, in 16-byte units.
    constexpr uint64_t STEP = 2 * Tf32::KSTR / 16;
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < steps) {
        wgmma_n64(d, ls[k], big + k * STEP);
        wgmma_n64(d, lb[k], small + k * STEP);
      }
    }
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < steps) wgmma_n64(d, lb[k], big + k * STEP);
    }
    wgmma_commit_wait();
    fence_regs(d);
    mbar_arrive(sm.empty + s);

    // Rows at or past n hold exact zeros. Lane (g, t) ends with the sums
    // of query 8g + 2t + e over the warp's 16 rows (reduce_tiles).
    float* red = sm.red + (int)(u & 1) * (Tf32::red_floats(p) / 2) +
                 (4 * MT + w) * (p + 1) * Tf32::TQ + 8 * g + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        v[c] = d[4 * c + e] * d[4 * c + e];
        v[c] += d[4 * c + 2 + e] * d[4 * c + 2 + e];
      }
      red[p * Tf32::TQ + e] = reduce_tiles(v, lane);
    }
#pragma unroll 1
    for (int o = 0; o < p; ++o) {
      const float al0 = i0 < n ? __ldg(a.alpha + (int64_t)i0 * p + o) : 0.f;
      const float al1 =
          i0 + 8 < n ? __ldg(a.alpha + (int64_t)(i0 + 8) * p + o) : 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          v[c] = d[4 * c + e] * al0;
          v[c] += d[4 * c + 2 + e] * al1;
        }
        red[o * Tf32::TQ + e] = reduce_tiles(v, lane);
      }
    }
    named_sync(1, 256);  // both solve warpgroups' partials written
    // Buffer u & 1 is written again two tiles on, after the next barrier.
    const int64_t t0 = ((int64_t)blockIdx.x + u * gridDim.x) * Tf32::TQ;
    store_slots<float, Tf32::TQ, 8, 256>(
        sm.red + (int)(u & 1) * (Tf32::red_floats(p) / 2), t0, a.n_q, p, 1,
        0, a.mean_out, a.var_out, (int)threadIdx.x);
  }
}

// This lane's query coordinates in a fill warpgroup's A operand of the
// cross term: queries q0 + g and q0 + g + 8 (rows of the m64 tile, q0 the
// warp's first), dimensions 8 kk + t and 8 kk + t + 4 (zero past d).
template <int DK>
__device__ __forceinline__ void load_query_frag(float (&qa)[DK / 8][4],
                                                const Args<float>& a,
                                                int64_t q0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < DK / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = 8 * kk + t + 4 * (r >> 1);
      qa[kk][r] = c < a.d ? __ldg(query_row(a.q, q0 + g + 8 * (r & 1),
                                            a.n_q, a.d) + c)
                          : 0.f;
    }
  }
}

// Fill warpgroup F: rows 64 F .. 64 F + 63 of each tile's K. The cross
// term q x^T (queries on M, rows on N) on the tensor cores in three TF32
// passes, the queries' halves from registers (loaded a tile ahead), x's
// from shared memory; then k_j = cov(max(xx_j - 2 x_j.q + qq, 0)) vm_j
// (vm_j = var_s2 mask_j) from the accumulator fragments, split into TF32
// halves and stored, two rows at a time, into the tile's K slot; rows
// from n to the solve's last k step are zeros (vm_j = 0 there). With DK = 16 (d > 8) the
// two k steps of the cross term run one after the other.
template <int KIND, int DK>
__device__ __forceinline__ void tf32_fill(const Tf32Smem& sm,
                                          const Args<float>& a,
                                          int64_t items) {
  const int F = (int)threadIdx.x / 128 - 2;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int n = a.n;
  // Rows 64-127 only where the solve reads them.
  const bool active = F == 0 || n > 64;
  const unsigned char* xb = sm.xop + F * 8 * 128;
  const uint64_t xbig = wgmma_desc(xb, Tf32::XSTR, 128);
  const uint64_t xsmall = wgmma_desc(xb + Tf32::XHALF, Tf32::XSTR, 128);
  constexpr uint64_t XSTEP = 2 * Tf32::XSTR / 16;
  float qa[DK / 8][4];
  if (items > 0) {
    load_query_frag<DK>(qa, a, (int64_t)blockIdx.x * Tf32::TQ + 16 * w, g,
                        t);
  }
  for (int64_t u = 0; u < items; ++u) {
    // qq of this lane's queries g and g + 8: its dimensions, then the 4
    // lanes t of the quad.
    float qq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s2 = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 8; ++kk) {
        s2 += qa[kk][h] * qa[kk][h];
        s2 += qa[kk][2 + h] * qa[kk][2 + h];
      }
      s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
      qq[h] = s2 + __shfl_xor_sync(0xffffffffu, s2, 2);
    }
    float cr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) cr[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 8; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(qa[kk][r], hi[r], lo[r]);
      if (active) {
        wgmma_fence();
        wgmma_n64(cr, lo, xbig + kk * XSTEP);
        wgmma_n64(cr, hi, xsmall + kk * XSTEP);
        wgmma_n64(cr, hi, xbig + kk * XSTEP);
        wgmma_commit_wait();
        fence_regs(cr);
      }
    }
    // The next tile's queries, in flight while this one is stored.
    if (u + 1 < items) {
      load_query_frag<DK>(
          qa, a, ((int64_t)blockIdx.x + (u + 1) * gridDim.x) * Tf32::TQ +
                     16 * w, g, t);
    }
    const int s = (int)(u % Tf32::NS);
    mbar_wait(sm.empty + s, ((unsigned)(u / Tf32::NS) & 1u) ^ 1u);
    if (active) {
      unsigned char* kb = sm.slots + s * Tf32::SLOT;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // Rows j, j + 1 of this lane; queries 16 w + g + 8 h.
        const int j = 64 * F + 8 * c + 2 * t;
        const float2 xx2 = *reinterpret_cast<const float2*>(sm.xx + j);
        const float2 vm2 = *reinterpret_cast<const float2*>(sm.vm + j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // Past n, vm is 0 and so is k: no branch in the loop.
            float r2 = (e ? xx2.y : xx2.x) - 2.f * cr[4 * c + 2 * h + e] +
                       qq[h];
            r2 = r2 > 0.f ? r2 : 0.f;
            const float k =
                cov_of<float, KIND>(r2, a.kind) * (e ? vm2.y : vm2.x);
            split_tf32(k, hi[e], lo[e]);
          }
          const int q = 16 * w + g + 8 * h;
          const int off = (j / 4) * Tf32::KSTR + (q / 8) * 128 +
                          (q % 8) * 16 + (j % 4) * 4;
          *reinterpret_cast<uint2*>(kb + off) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(kb + Tf32::HALF + off) =
              make_uint2(lo[0], lo[1]);
        }
      }
      fence_async_shared();
    }
    mbar_arrive(sm.full + s);
  }
}

// The block of kernels 6 and 7's float32 tiled bodies: the ring's
// mbarriers, the fill's operands staged by `stage()` (and made visible to
// the tensor cores), then two solve warpgroups and two fill warpgroups
// (`fill(items)`) over the block's 64-query tiles, a ring of NS K slots
// between them (full and empty mbarriers). Registers move from the fill
// warpgroups to the solve warpgroup of rows 64-127, whose chol_inv halves
// take 128 a thread.
template <class Stage, class Fill>
__device__ __forceinline__ void tf32_block(const Tf32Smem& sm,
                                           const Args<float>& a,
                                           const Stage& stage,
                                           const Fill& fill) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < Tf32::NS; ++s) {
      mbar_init(sm.full + s, 256);
      mbar_init(sm.empty + s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage();
  fence_async_shared();
  __syncthreads();
  const int64_t items = block_items((a.n_q + Tf32::TQ - 1) / Tf32::TQ);
  const int wg = (int)threadIdx.x / 128;
  if (wg >= 2) {
    regs_dec<88>();
    fill(items);
  } else if (wg == 1) {
    regs_inc<208>();
    tf32_solve<1>(sm, a, items);
  } else {
    tf32_solve<0>(sm, a, items);
  }
}

// Kernel 7's float32 tiled body: x's TF32 halves, the rows' squared norms
// and var_s2 mask_j staged once a block for tf32_fill.
template <int KIND, int DK>
__global__ void __launch_bounds__(Tf32::NTH, 1)
tiled_expanded_tf32(const Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Tf32Smem sm(smem_raw, a.p);
  tf32_block(sm, a, [&] {
    const float var_s2 = scale_of(a);
    for (int idx = threadIdx.x; idx < NBV * DK; idx += Tf32::NTH) {
      const int j = idx / DK, c = idx - j * DK;
      const float v = j < a.n && c < a.d ? a.x[(int64_t)j * a.d + c] : 0.f;
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      const int off =
          (c / 4) * Tf32::XSTR + (j / 8) * 128 + (j % 8) * 16 + (c % 4) * 4;
      *reinterpret_cast<uint32_t*>(sm.xop + off) = hi;
      *reinterpret_cast<uint32_t*>(sm.xop + Tf32::XHALF + off) = lo;
    }
    for (int j = threadIdx.x; j < NBV; j += Tf32::NTH) {
      sm.xx[j] = j < a.n ? row_sq_norm(a.x + (int64_t)j * a.d, a.d) : 0.f;
      sm.vm[j] = j < a.n ? var_s2 * a.mask[j] : 0.f;
    }
  }, [&](int64_t items) { tf32_fill<KIND, DK>(sm, a, items); });
}

// Kernel 6's fill warpgroups: the bare cov(r2) of each tile's K with r2 by
// kernel 1's per-dimension differences on the CUDA cores, x staged
// transposed in shared memory (xt[c][j], read as 4 rows a 16-byte
// broadcast), the query's coordinates in registers, loaded a tile ahead.
// A thread owns query tid % 64 of the tile and the 4-row groups 4 rg,
// 4 rg + 16, ... (rg = tid / 64): its k of 4 rows are 16 contiguous bytes of
// each TF32 half in the slot, and a warp's 32 queries 512 contiguous bytes.
// Its loop stops at the count; rows from n to the solve's last k step are
// the zeros the block stored once (the group that holds row n - 1 stores
// zeros past it), so no element pays for the count or the mask.
template <int KIND>
__device__ __forceinline__ void folded_fill(const Tf32Smem& sm,
                                            const Args<float>& a,
                                            int64_t items) {
  const int tid = (int)threadIdx.x - 256;
  const int ql = tid & 63, rg = tid >> 6;
  const int n = a.n, d = a.d;
  const float* xt = reinterpret_cast<const float*>(sm.xop);
  float qv[D_MAX], qn[D_MAX];
  if (items > 0) {
    load_row(a.q, (int64_t)blockIdx.x * Tf32::TQ + ql, a.n_q, d, qv);
  }
  for (int64_t u = 0; u < items; ++u) {
    // The next tile's query, in flight while this one is filled.
    if (u + 1 < items) {
      load_row(a.q, ((int64_t)blockIdx.x + (u + 1) * gridDim.x) * Tf32::TQ +
                        ql, a.n_q, d, qn);
    }
    const int s = (int)(u % Tf32::NS);
    mbar_wait(sm.empty + s, ((unsigned)(u / Tf32::NS) & 1u) ^ 1u);
    unsigned char* kb = sm.slots + s * Tf32::SLOT + ql * 16;
#pragma unroll
    for (int r = 0; r < NBV / 16; ++r) {
      const int j = 16 * r + 4 * rg;
      if (j >= n) break;
      float r2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < D_MAX; ++c) {
        if (c >= d) break;
        const float4 xv = *reinterpret_cast<const float4*>(xt + c * NBV + j);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float diff = xs[e] - qv[c];
          r2[e] = r2[e] + diff * diff;
        }
      }
      float k[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) k[e] = cov_of<float, KIND>(r2[e], a.kind);
      if (j + 4 > n) {
#pragma unroll
        for (int e = 1; e < 4; ++e) k[e] = j + e < n ? k[e] : 0.f;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(k[e], hi[e], lo[e]);
      const int off = (j / 4) * Tf32::KSTR;
      *reinterpret_cast<uint4*>(kb + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(kb + Tf32::HALF + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_async_shared();
    mbar_arrive(sm.full + s);
#pragma unroll
    for (int c = 0; c < D_MAX; ++c) qv[c] = qn[c];
  }
}

// Kernel 6's float32 tiled body: both K slots zeroed and x staged
// transposed once a block for folded_fill; tf32_solve's product takes the
// folded chol_inv as it takes kernel 7's.
template <int KIND>
__global__ void __launch_bounds__(Tf32::NTH, 1)
tiled_folded_tf32(const Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Tf32Smem sm(smem_raw, a.p);
  tf32_block(sm, a, [&] {
    uint4* slots = reinterpret_cast<uint4*>(sm.slots);
    for (int i = threadIdx.x; i < Tf32::NS * Tf32::SLOT / 16;
         i += Tf32::NTH) {
      slots[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    float* xt = reinterpret_cast<float*>(sm.xop);
    for (int idx = threadIdx.x; idx < D_MAX * NBV; idx += Tf32::NTH) {
      const int c = idx / NBV, j = idx - c * NBV;
      xt[idx] = j < a.n && c < a.d ? a.x[(int64_t)j * a.d + c] : 0.f;
    }
  }, [&](int64_t items) { folded_fill<KIND>(sm, a, items); });
}

// ---------------------------------------------------------------------------
// Kernel 4's float32 tiled body: warp-specialised FP32, and kernel 5's: H
// independent warpgroup chains (their designs are in the header note)
// ---------------------------------------------------------------------------
struct Ws {
  static constexpr int TQ = 128;   // queries a tile
  static constexpr int NS = 2;     // K slots in the ring
  static constexpr int SW = 4;     // solve warps (one warpgroup)
  static constexpr int NTH = 384;  // and two fill warpgroups
  static constexpr int FTH = NTH - 32 * SW;
  // A solve thread's register tile: TM rows x TN queries; a warp is 2 row
  // lanes x 16 query lanes, 16 rows x TQ queries, and takes the row tiles
  // g and 7 - g, so every solve warp does the same work.
  static constexpr int TM = 8, TN = 8, WQ = 16;
  static constexpr int LS = NBV + 4;  // ls_stride<float>(NBV)
  static __host__ __device__ constexpr size_t bytes(int p, int d) {
    return sizeof(float) * ((size_t)NBV * LS + (size_t)NS * NBV * TQ +
                            (size_t)SW * (p + 1) * TQ + (size_t)NBV * (d + 1)) +
           2 * NS * sizeof(uint64_t);
  }
};

struct WsSmem {
  float *ls, *ks, *red, *xs, *ms;
  uint64_t *full, *empty;
  __device__ __forceinline__ WsSmem(unsigned char* raw, int p, int d) {
    ls = reinterpret_cast<float*>(raw);
    ks = ls + NBV * Ws::LS;
    red = ks + Ws::NS * NBV * Ws::TQ;
    xs = red + Ws::SW * (p + 1) * Ws::TQ;
    ms = xs + NBV * d;
    full = reinterpret_cast<uint64_t*>(
        (reinterpret_cast<uintptr_t>(ms + NBV) + 7) & ~uintptr_t(7));
    empty = full + Ws::NS;
  }
};

// part[c] (this thread's TN queries) summed over the two row lanes; the
// lanes of row lane 0 store it to (first) or add it to dst, their queries
// 4 lc + c % 4 + 64 (c / 4).
template <int TN>
__device__ __forceinline__ void ws_add(float (&part)[TN], float* dst,
                                       int lr, bool first) {
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    part[c] += __shfl_xor_sync(0xffffffffu, part[c], 16);
  }
  if (lr == 0) {
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      float* q = dst + (c / 4) * 64 + c % 4;
      *q = first ? part[c] : *q + part[c];
    }
  }
}

// A = L^-1 K of the 16-row tile at r0 (kernels 4 and 5): the thread's TM
// rows x TN queries (4 lc + c, and at TN = 8 also 64 + 4 lc + c - 4) of a
// TQ = 16 TN query tile, each a_i over j from 0 in ascending order as
// kernel 1's solve. ks points at the thread's first query column.
template <int TN>
__device__ __forceinline__ void ws_rows(const float* ls, const float* ks,
                                        int n, int r0, int lr,
                                        float (&acc)[Ws::TM][TN]) {
  constexpr int TM = Ws::TM, TQ = 16 * TN, LS = Ws::LS;
  const int jend = r0 < n ? min(n, r0 + 16) : 0;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
  }
  const float* lp = ls + r0 + lr * TM;
#pragma unroll 4
  for (int j = 0; j < jend; ++j) {
    const float4 l0 = *reinterpret_cast<const float4*>(lp + j * LS);
    const float4 l1 = *reinterpret_cast<const float4*>(lp + j * LS + 4);
    const float l[TM] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    float k[TN];
#pragma unroll
    for (int v = 0; v < TN / 4; ++v) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + j * TQ + 64 * v);
      k[4 * v] = kv.x, k[4 * v + 1] = kv.y, k[4 * v + 2] = kv.z,
      k[4 * v + 3] = kv.w;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] += l[r] * k[c];
    }
  }
}

// The rows of acc (the tile at r0) into the warp's partial sums red
// ([p + 1][TQ], at the thread's first query column): a^2 and alpha^T a,
// stored (first) or added. Rows at or past n hold exact zeros (their
// chol_inv rows are staged as zeros).
template <int TN>
__device__ __forceinline__ void ws_part(const float (&acc)[Ws::TM][TN],
                                        float* red, const Args<float>& a,
                                        int r0, int lr, bool first) {
  constexpr int TM = Ws::TM, TQ = 16 * TN;
  const int n = a.n, p = a.p;
  float part[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    part[c] = 0.f;
#pragma unroll
    for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * acc[r][c];
  }
  ws_add(part, red + p * TQ, lr, first);
#pragma unroll 1
  for (int o = 0; o < p; ++o) {
    float al[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = r0 + lr * TM + r;
      al[r] = i < n ? __ldg(a.alpha + (int64_t)i * p + o) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      part[c] = 0.f;
#pragma unroll
      for (int r = 0; r < TM; ++r) part[c] += acc[r][c] * al[r];
    }
    ws_add(part, red + o * TQ, lr, first);
  }
}

// Solve warp w's share of one tile of kernel 4: the row tiles w and 7 - w
// (ws_rows), each into the warp's partial sums red[w][c][q] (ws_part) once
// solved. `read()` runs once the warp has read the K tile.
template <class Read>
__device__ __forceinline__ void ws_tile(const float* ls, const float* ks,
                                        float* red, const Args<float>& a,
                                        int w, int lane, const Read& read) {
  constexpr int TN = Ws::TN, TQ = 16 * TN;
  const int lc = lane % Ws::WQ, lr = lane / Ws::WQ;
  red += w * (a.p + 1) * TQ + 4 * lc;
  ks += 4 * lc;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int r0 = 16 * (half == 0 ? w : 7 - w);
    float acc[Ws::TM][TN];
    ws_rows<TN>(ls, ks, a.n, r0, lr, acc);
    if (half == 1) read();
    ws_part<TN>(acc, red, a, r0, lr, half == 0);
  }
}

// The solve warps: per tile, ws_tile; then the four warps' sums are
// stored.
__device__ __forceinline__ void ws_solve(const WsSmem& sm,
                                         const Args<float>& a,
                                         int64_t items) {
  constexpr int TQ = Ws::TQ;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int64_t u = 0; u < items; ++u) {
    const int s = (int)(u % Ws::NS);
    mbar_wait(sm.full + s, (unsigned)(u / Ws::NS) & 1u);
    // The last tile's sums have been stored (the barrier of its end).
    ws_tile(sm.ls, sm.ks + s * NBV * TQ, sm.red, a, w, lane,
            [&] { mbar_arrive(sm.empty + s); });  // K slot s read
    named_sync(1, 32 * Ws::SW);  // every warp's partials written
    const int64_t t0 = ((int64_t)blockIdx.x + u * gridDim.x) * TQ;
    store_slots<float, TQ, Ws::SW, 32 * Ws::SW>(sm.red, t0, a.n_q, a.p, 1,
                                                0, a.mean_out, a.var_out,
                                                (int)threadIdx.x);
    named_sync(1, 32 * Ws::SW);  // stored; the partials may be rewritten
  }
}

// Column ql of a TQ-query K tile: k (kernel 1's stationary_k) of the query
// qv (qrow its row) at rows j0, j0 + JS, ... below the count.
template <int KIND, int TQ, int JS>
__device__ __forceinline__ void fill_column(float* ks, const float* xs,
                                            const float* ms,
                                            const Args<float>& a,
                                            float var_s2,
                                            const float (&qv)[D_MAX],
                                            const float* qrow, int ql,
                                            int j0) {
#pragma unroll 4
  for (int j = j0; j < a.n; j += JS) {
    ks[j * TQ + ql] = variant_k<float, KIND, K_STATIONARY>(
        xs, ms, nullptr, qv, qrow, 0.f, a.d, var_s2, a.kind, j);
  }
}

// The fill warps: k of each tile into the ring.
template <int KIND>
__device__ __forceinline__ void ws_fill(const WsSmem& sm,
                                        const Args<float>& a,
                                        int64_t items) {
  constexpr int TQ = Ws::TQ;
  const int tid = (int)threadIdx.x - 32 * Ws::SW;
  const int ql = tid % TQ;
  const float var_s2 = scale_of(a);
  for (int64_t u = 0; u < items; ++u) {
    const int s = (int)(u % Ws::NS);
    const int64_t qi = ((int64_t)blockIdx.x + u * gridDim.x) * TQ + ql;
    float qv[D_MAX];
    load_row(a.q, qi, a.n_q, a.d, qv);
    const float* qrow = query_row(a.q, qi, a.n_q, a.d);
    mbar_wait(sm.empty + s, ((unsigned)(u / Ws::NS) & 1u) ^ 1u);
    fill_column<KIND, TQ, Ws::FTH / TQ>(sm.ks + s * NBV * TQ, sm.xs, sm.ms,
                                        a, var_s2, qv, qrow, ql, tid / TQ);
    mbar_arrive(sm.full + s);
  }
}

// Kernel 4's float32 tiled body: one persistent block an SM, chol_inv
// resident, a solve warpgroup and two fill warpgroups over 128-query
// tiles, a ring of NS K slots between them (full and empty mbarriers).
template <int KIND>
__global__ void __launch_bounds__(Ws::NTH, 1)
tiled_pipelined_ws(const Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WsSmem sm(smem_raw, a.p, a.d);
  if (threadIdx.x == 0) {
    for (int s = 0; s < Ws::NS; ++s) {
      mbar_init(sm.full + s, Ws::FTH);
      mbar_init(sm.empty + s, 32 * Ws::SW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_chol_inv<float, NBV, Ws::NTH>(sm.ls, a.chol_inv, a.cap, a.n);
  stage_rows<float, Ws::NTH>(sm.xs, sm.ms, a.x, a.mask, a.n, a.d);
  __syncthreads();
  const int64_t items = block_items((a.n_q + Ws::TQ - 1) / Ws::TQ);
  if ((int)threadIdx.x >= 32 * Ws::SW) {
    regs_dec<96>();
    ws_fill<KIND>(sm, a, items);
  } else {
    regs_inc<232>();
    ws_solve(sm, a, items);
  }
}

// Kernel 5's float32 tiled body at HS chains: one warpgroup a chain, each
// with its own K tile of TQ queries, which takes the chain's partial sums
// once its solve has read it.
template <int HS>
struct Chains {
  // A solve thread's queries: 8 x 8 register tiles at two chains (255
  // registers a thread), 8 x 4 at four (128).
  static constexpr int TN = HS == 2 ? 8 : 4;
  static constexpr int TQ = 16 * TN;  // queries a chain's tile
  static constexpr int NTH = 128 * HS;
  // chol_inv transposed, x and the mask, then each chain's K tile.
  static __host__ __device__ constexpr size_t bytes(int d) {
    return sizeof(float) * ((size_t)NBV * Ws::LS + (size_t)NBV * (d + 1) +
                            (size_t)HS * NBV * TQ);
  }
  // The partial sums ([4 warps][p + 1][TQ]) fit in the K tile, and the
  // block fits at every d: the tiled body runs at every p and d.
  static_assert(4 * (P_MAX + 1) <= NBV, "partials exceed the K tile");
  static_assert(bytes(D_MAX) <= SMEM_MAX, "chains exceed shared memory");
};

// One persistent block an SM: chol_inv (transposed), x and the mask staged
// once behind the block's only barrier; then chain g takes the block's
// tiles g, g + HS, ... (tile blockIdx.x + (u HS + g) gridDim.x of its item
// u). Per tile a chain fills its K, syncs on its own named barrier 1 + g
// (128 threads), solves both row tiles of each warp into registers
// (ws_rows), syncs, writes its partial sums over the K tile (ws_part),
// syncs, stores them and syncs again before the next fill. No barrier
// spans two chains, so chains with more or fewer tiles than the others
// never wait on each other, and the warp schedulers overlap one chain's
// covariances with another's shared loads and FMAs.
template <int KIND, int HS>
__global__ void __launch_bounds__(Chains<HS>::NTH, 1)
tiled_interleaved_chains(const Args<float> a) {
  using C = Chains<HS>;
  constexpr int TQ = C::TQ, TN = C::TN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ls = reinterpret_cast<float*>(smem_raw);
  float* xs = ls + NBV * Ws::LS;
  float* ms = xs + NBV * a.d;
  const int g = (int)threadIdx.x / 128, tid = (int)threadIdx.x & 127;
  const int w = tid >> 5, lc = tid % Ws::WQ, lr = (tid & 31) / Ws::WQ;
  float* ks = ms + NBV + g * NBV * TQ;
  stage_chol_inv<float, NBV, C::NTH>(ls, a.chol_inv, a.cap, a.n);
  stage_rows<float, C::NTH>(xs, ms, a.x, a.mask, a.n, a.d);
  __syncthreads();
  const float var_s2 = scale_of(a);
  const int64_t m = block_items((a.n_q + TQ - 1) / TQ);
  const int ql = tid % TQ;
  for (int64_t u = g; u < m; u += HS) {
    const int64_t t = (int64_t)blockIdx.x + u * gridDim.x;
    const int64_t qi = t * TQ + ql;
    float qv[D_MAX];
    load_row(a.q, qi, a.n_q, a.d, qv);
    fill_column<KIND, TQ, 128 / TQ>(ks, xs, ms, a, var_s2, qv,
                                    query_row(a.q, qi, a.n_q, a.d), ql,
                                    tid / TQ);
    named_sync(1 + g, 128);  // K filled
    float acc0[Ws::TM][TN], acc1[Ws::TM][TN];
    ws_rows<TN>(ls, ks + 4 * lc, a.n, 16 * w, lr, acc0);
    ws_rows<TN>(ls, ks + 4 * lc, a.n, 16 * (7 - w), lr, acc1);
    named_sync(1 + g, 128);  // K read: its tile takes the partials
    float* red = ks + w * (a.p + 1) * TQ + 4 * lc;
    ws_part<TN>(acc0, red, a, 16 * w, lr, true);
    ws_part<TN>(acc1, red, a, 16 * (7 - w), lr, false);
    named_sync(1 + g, 128);  // partials written
    store_slots<float, TQ, 4, 128>(ks, t * TQ, a.n_q, a.p, 1, 0,
                                   a.mean_out, a.var_out, tid);
    named_sync(1 + g, 128);  // stored: K may be refilled
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

// Block threads of the float64 pipelined and interleaved bodies: a
// 32-query tile, so that two k slots fit beside chol_inv.
constexpr int NT64 = NT / 2;

template <typename T, int KIND, int KF>
cudaError_t launch_serial(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache, cache16;
  if constexpr (sizeof(T) == 4) {
    // Kernels 6 and 7's float32 bodies: the product on the tensor cores.
    const size_t smem = Tf32::bytes(a.p);
    if (a.n > NBV) return launch_streamed<T, KF>(a, stream);
    if constexpr (KF == K_BARE) {
      return launch_persistent(cache, tiled_folded_tf32<KIND>, smem,
                               Tf32::TQ, Tf32::NTH, a, stream);
    } else if (a.d > 8) {
      return launch_persistent(cache16, tiled_expanded_tf32<KIND, 16>, smem,
                               Tf32::TQ, Tf32::NTH, a, stream);
    } else {
      return launch_persistent(cache, tiled_expanded_tf32<KIND, 8>, smem,
                               Tf32::TQ, Tf32::NTH, a, stream);
    }
  } else {
    const size_t smem = VSmem<T, NT>::bytes(1, 1, a.p, a.d);
    if (a.n > NBV || smem > SMEM_MAX) {
      return launch_streamed<T, KF>(a, stream);
    }
    return launch_persistent(cache, tiled_serial<T, KIND, KF>, smem,
                             Tile<NBV, NT>::TQ, NT, a, stream);
  }
}

template <typename T, int KIND>
cudaError_t launch_pipelined(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  if constexpr (sizeof(T) == 4) {
    // Kernel 4's float32 body: warp-specialised.
    const size_t smem = Ws::bytes(a.p, a.d);
    if (a.n > NBV) return launch_streamed<T, K_STATIONARY>(a, stream);
    return launch_persistent(cache, tiled_pipelined_ws<KIND>, smem, Ws::TQ,
                             Ws::NTH, a, stream);
  } else {
    const size_t smem = VSmem<T, NT64>::bytes(2, 2, a.p, a.d);
    if (a.n > NBV || smem > SMEM_MAX) {
      return launch_streamed<T, K_STATIONARY>(a, stream);
    }
    return launch_persistent(cache, tiled_pipelined<T, KIND, NT64>, smem,
                             Tile<NBV, NT64>::TQ, NT64, a, stream);
  }
}

template <typename T, int KIND, int HS>
cudaError_t launch_interleaved(const Args<T>& a, cudaStream_t stream) {
  static GridCache cache;
  if constexpr (sizeof(T) == 4) {
    // Kernel 5's float32 body: HS warpgroup chains.
    if (a.n > NBV) return launch_streamed<T, K_STATIONARY>(a, stream);
    return launch_persistent(cache, tiled_interleaved_chains<KIND, HS>,
                             Chains<HS>::bytes(a.d),
                             HS * Chains<HS>::TQ, Chains<HS>::NTH, a, stream);
  } else {
    const size_t smem = VSmem<T, NT64>::bytes(2, HS, a.p, a.d);
    if (a.n > NBV || smem > SMEM_MAX) {
      return launch_streamed<T, K_STATIONARY>(a, stream);
    }
    return launch_persistent(cache, tiled_interleaved<T, KIND, NT64, HS>,
                             smem, HS * Tile<NBV, NT64>::TQ, NT64, a, stream);
  }
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
