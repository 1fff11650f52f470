"""Kernel 1's pipelined, interleaved and folded variants, timed beside it.

Counterpart of ``benchmarks/pipelined_predict.py``. That script's three
Pallas kernels restructure kernel 1 (``_gp_predict_kernel``, the
stationary GP posterior numerators) to overlap the covariance (exp, on
the TPU's vector unit) with the ``chol_inv @ k`` matmul. Here each is a
hand-written CUDA kernel for Hopper in ``csrc/gp_predict_variants.cu``,
whose header says what each schedule does on the H100:

- ``pipelined_gp_predict`` (``_pipelined_kernel`` ``:44``): the TPU's
  two-stage pipeline as producer and consumer warps. In float32 a block
  has a solve warpgroup and two fill warpgroups, which compute k tiles
  into a ring of two slots and hand them over by mbarriers; the solve
  threads hold 8 x 8 register tiles and each ``a_i`` runs over ``j`` in
  kernel 1's order (``run`` reports whether the outputs are bit for bit
  kernel 1's). In float64 a block solves one tile while it builds the
  next, one barrier a tile;
- ``interleaved_gp_predict`` (``_interleaved_kernel`` ``:141``): ``halves``
  (2 or 4) tiles a group, each sub-tile's build following the previous
  sub-tile's solve with no barrier between;
- ``folded_gp_predict`` (``_folded_kernel`` ``:170``): ``var_s2 * mask``
  folded into the columns of ``chol_inv`` once per call, outside the
  kernel, which builds a bare ``cov(r^2)``.

Each wrapper keeps the JAX signature. ``tile`` and ``interpret`` are the
TPU's (the Pallas block width and its interpret mode) and are accepted
and unused, as the port does for ``compute_roa``'s ``segment_steps``;
``count`` (``None``: the capacity) bounds the kernels' loops as in kernel
1. A CPU tensor goes to the plain version, a CUDA tensor to the kernel or
the call raises; nothing falls back. The wrappers are forward only, as the
JAX originals, which define no derivative rule: inputs that require a
gradient raise. Each ``*_cuda`` counts its launches in ``launches``.

``run`` times kernel 1 and every variant (this module's three and the
expanded-distance kernel of :mod:`.distance_mxu_experiment`) on one set
of kernel inputs, in turns, and reports each variant's largest difference
from kernel 1 and its speed-up over it, as the JAX ``main`` does. On a
machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.pipelined_predict

runs it on ``bench.py``'s GP (128 points, RBF, lengthscales 0.3) at 2^20
queries.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from ..ops import gp_kernel
from ..ops.gp_kernel import _scalar_tensor, gp_predict_plain

__all__ = ["pipelined_gp_predict", "interleaved_gp_predict",
           "folded_gp_predict", "pipelined_gp_predict_plain",
           "interleaved_gp_predict_plain", "folded_gp_predict_plain",
           "pipelined_gp_predict_cuda", "interleaved_gp_predict_cuda",
           "folded_gp_predict_cuda", "fold_chol_inv", "kernel_inputs",
           "bench_gp", "run", "main"]

HALVES = (2, 4)


def _forward_only(*tensors):
    """Raise on an input that requires a gradient (no derivative rule)."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError("the kernel-1 variants are forward only, as "
                           "their JAX originals; call them on inputs that "
                           "do not require a gradient, or under "
                           "torch.no_grad()")


def _check_halves(halves):
    if halves not in HALVES:
        raise ValueError("halves must be 2 or 4, got {!r}".format(halves))


def launch_variant(entry, wrapper, points_scaled, x_scaled, chol_inv,
                   alpha, mask, kernel_variance_s2, kind, count, lead=()):
    """Launch the variants library's C function ``entry`` (after the item
    size, the integer arguments ``lead``) through kernel 1's checks
    (:func:`~safe_learning_tpu_torch.ops.gp_kernel.launch_stationary`),
    and add one to ``wrapper.launches`` when it launched."""
    def c_function(lib, dtype):
        return getattr(lib, entry), (torch.finfo(dtype).bits // 8,) + lead

    mean_num, var_num, launched = gp_kernel.launch_stationary(
        c_function, gp_kernel.variants_library, entry, points_scaled,
        x_scaled, chol_inv, alpha, mask, kernel_variance_s2, kind, count)
    wrapper.launches += launched
    return mean_num, var_num


# ---------------------------------------------------------------------------
# Pipelined
# ---------------------------------------------------------------------------
def pipelined_gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha,
                               mask, kernel_variance_s2, kind="rbf",
                               count=None):
    """Plain PyTorch version: kernel 1's function
    (:func:`~safe_learning_tpu_torch.ops.gp_kernel.gp_predict_plain`),
    which the pipeline computes in another schedule."""
    return gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha, mask,
                            kernel_variance_s2, kind=kind, count=count)


def pipelined_gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha,
                              mask, kernel_variance_s2, kind="rbf",
                              count=None):
    """Launch the pipelined kernel (contract and precondition of
    :func:`~safe_learning_tpu_torch.ops.gp_kernel.gp_predict_cuda`)."""
    return launch_variant("gp_pipelined", pipelined_gp_predict_cuda,
                          points_scaled, x_scaled, chol_inv, alpha, mask,
                          kernel_variance_s2, kind, count)


#: Kernel launches since the last reset (``chip_smoke.py`` resets it).
pipelined_gp_predict_cuda.launches = 0


def pipelined_gp_predict(points_scaled, x_scaled, chol_inv, alpha, mask,
                         kernel_variance_s2, kind="rbf", tile=1024,
                         interpret=False, count=None):
    """Kernel 1's outputs by the pipelined schedule (``(Q, p)``, ``(Q,)``).

    ``tile`` and ``interpret`` are the TPU's and unused.
    """
    _forward_only(points_scaled, x_scaled, chol_inv, alpha, mask,
                  kernel_variance_s2)
    if points_scaled.device.type == "cpu":
        return pipelined_gp_predict_plain(points_scaled, x_scaled, chol_inv,
                                          alpha, mask, kernel_variance_s2,
                                          kind=kind, count=count)
    return pipelined_gp_predict_cuda(points_scaled, x_scaled, chol_inv,
                                     alpha, mask, kernel_variance_s2,
                                     kind=kind, count=count)


# ---------------------------------------------------------------------------
# Interleaved
# ---------------------------------------------------------------------------
def interleaved_gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha,
                                 mask, kernel_variance_s2, kind="rbf",
                                 halves=2, count=None):
    """Plain PyTorch version: kernel 1's function, whatever ``halves``."""
    _check_halves(halves)
    return gp_predict_plain(points_scaled, x_scaled, chol_inv, alpha, mask,
                            kernel_variance_s2, kind=kind, count=count)


def interleaved_gp_predict_cuda(points_scaled, x_scaled, chol_inv, alpha,
                                mask, kernel_variance_s2, kind="rbf",
                                halves=2, count=None):
    """Launch the interleaved kernel with ``halves`` (2 or 4) sub-tiles a
    group (contract of :func:`pipelined_gp_predict_cuda`)."""
    _check_halves(halves)
    return launch_variant("gp_interleaved", interleaved_gp_predict_cuda,
                          points_scaled, x_scaled, chol_inv, alpha, mask,
                          kernel_variance_s2, kind, count, lead=(halves,))


interleaved_gp_predict_cuda.launches = 0


def interleaved_gp_predict(points_scaled, x_scaled, chol_inv, alpha, mask,
                           kernel_variance_s2, kind="rbf", tile=1024,
                           halves=2, interpret=False, count=None):
    """Kernel 1's outputs by the interleaved schedule.

    ``tile`` and ``interpret`` are the TPU's and unused.
    """
    _forward_only(points_scaled, x_scaled, chol_inv, alpha, mask,
                  kernel_variance_s2)
    if points_scaled.device.type == "cpu":
        return interleaved_gp_predict_plain(
            points_scaled, x_scaled, chol_inv, alpha, mask,
            kernel_variance_s2, kind=kind, halves=halves, count=count)
    return interleaved_gp_predict_cuda(points_scaled, x_scaled, chol_inv,
                                       alpha, mask, kernel_variance_s2,
                                       kind=kind, halves=halves, count=count)


# ---------------------------------------------------------------------------
# Folded
# ---------------------------------------------------------------------------
def fold_chol_inv(chol_inv, mask, kernel_variance_s2):
    """``chol_inv * (var_s2 * mask)[None, :]``, the JAX wrapper's fold
    (``benchmarks/pipelined_predict.py:263-265``)."""
    scale = _scalar_tensor(kernel_variance_s2, chol_inv)
    return chol_inv * (scale * mask.to(chol_inv.dtype))[None, :]


def folded_gp_predict_plain(points_scaled, x_scaled, chol_inv_scaled, alpha,
                            kind="rbf", count=None):
    """Plain PyTorch version of the folded kernel: ``k = cov(r^2)`` with
    no scale and no mask, ``a = chol_inv_scaled @ k`` (``count`` ignored:
    the full-capacity math)."""
    from ..functions.gp import STATIONARY_COVARIANCES

    r2 = None
    for i in range(points_scaled.shape[1]):
        diff = x_scaled[:, i][:, None] - points_scaled[:, i][None, :]
        r2 = diff * diff if r2 is None else r2 + diff * diff
    a = torch.matmul(chol_inv_scaled, STATIONARY_COVARIANCES[kind](r2))
    return torch.matmul(a.T, alpha), (a * a).sum(dim=0)


def folded_gp_predict_cuda(points_scaled, x_scaled, chol_inv_scaled, alpha,
                           kind="rbf", count=None):
    """Launch the folded kernel on an already folded ``chol_inv``
    (:func:`fold_chol_inv`); ``count`` as in kernel 1, whose precondition
    the fold keeps."""
    return launch_variant("gp_folded", folded_gp_predict_cuda, points_scaled,
                          x_scaled, chol_inv_scaled, alpha, None, None, kind,
                          count)


folded_gp_predict_cuda.launches = 0


def folded_gp_predict(points_scaled, x_scaled, chol_inv, alpha, mask,
                      kernel_variance_s2, kind="rbf", tile=1024,
                      interpret=False, count=None):
    """Kernel 1's outputs with ``var_s2 * mask`` folded into ``chol_inv``.

    The fold is an elementwise PyTorch op, once per call; equal to kernel
    1 in exact arithmetic, not bit for bit (the scale rounds in the factor
    instead of in k). ``tile`` and ``interpret`` are the TPU's and unused.
    """
    _forward_only(points_scaled, x_scaled, chol_inv, alpha, mask,
                  kernel_variance_s2)
    folded = fold_chol_inv(chol_inv, mask, kernel_variance_s2)
    if points_scaled.device.type == "cpu":
        return folded_gp_predict_plain(points_scaled, x_scaled, folded,
                                       alpha, kind=kind, count=count)
    return folded_gp_predict_cuda(points_scaled, x_scaled, folded, alpha,
                                  kind=kind, count=count)


# ---------------------------------------------------------------------------
# The timed comparison
# ---------------------------------------------------------------------------
def kernel_inputs(gp, points):
    """Kernel 1's arguments for ``gp`` at raw query ``points``:
    ``(points / ls, X / ls, chol_inv, alpha, mask, var * scale^2)``."""
    ls = gp.kernel.lengthscales
    points = torch.as_tensor(points, dtype=gp.X_buf.dtype,
                             device=gp.X_buf.device)
    return ((points / ls).contiguous(), (gp.X_buf / ls).contiguous(),
            gp.chol_inv, gp.alpha, gp._mask(),
            gp.kernel.variance * gp.scale ** 2)


def bench_gp():
    """``bench.py``'s GP (``bench.py:58-73``): 128 points near the origin
    of the pendulum's (x, v, u), RBF with variance 1 and lengthscales
    0.3, noise 1e-4, a linear prior mean; in ``config.dtype`` on
    ``config.device``."""
    from .. import GaussianProcess, LinearSystem, RBF

    a = np.array([[0.25, 0.05], [0.0, 0.3]])
    rng = np.random.default_rng(0)
    n_train = 128
    x_train = np.column_stack([
        rng.uniform(-0.4, 0.4, n_train), rng.uniform(-0.4, 0.4, n_train),
        np.zeros(n_train)])
    y_train = x_train[:, :2] @ a.T + 0.02 * np.sin(3 * x_train[:, :2])
    return GaussianProcess(RBF(1.0, [0.3] * 3, input_dim=3), x_train,
                           y_train, noise_variance=1e-4, beta=2.0,
                           mean_function=LinearSystem([a, np.zeros((2, 1))]))


def variant_calls(inputs, kind="rbf", count=None):
    """``(name, call)`` of kernel 1 and every variant, in ``run``'s order;
    each call returns ``(mean_num, var_num)``."""
    from .distance_mxu_experiment import fused_predict_mxu_dist

    def call(fn, **kw):
        return lambda: fn(*inputs, kind=kind, count=count, **kw)

    return [("kernel1", call(gp_kernel.fused_gp_predict)),
            ("pipelined", call(pipelined_gp_predict)),
            ("interleaved2", call(interleaved_gp_predict, halves=2)),
            ("interleaved4", call(interleaved_gp_predict, halves=4)),
            ("folded", call(folded_gp_predict)),
            ("expanded", call(fused_predict_mxu_dist))]


def time_calls(calls, reps, batch):
    """CUDA-event milliseconds of one call of each, ``reps`` rounds in
    turns (the calls' order, then again), ``batch`` calls back to back a
    measurement: ``{name: [ms of each round]}``."""
    runs = {name: [] for name, _ in calls}
    for name, fn in calls:  # warm-up
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for name, fn in calls:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(batch):
                fn()
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end) / batch)
    return runs


def run(inputs, reps=5, kind="rbf", count=None, batch=10):
    """Time kernel 1 and every variant on one set of kernel inputs.

    ``inputs`` are kernel 1's arguments on the card (:func:`kernel_inputs`).
    The calls run in turns, kernel 1, pipelined, interleaved by 2 and by
    4, folded, expanded, then again, ``reps`` rounds, because the card's
    times drift between calls. Returns, per name, the median ``ms`` of a
    call and every round's (``runs``), and for each variant its largest
    absolute difference from kernel 1's mean and variance numerators and
    its ``speedup`` over kernel 1 (kernel 1's median over the variant's).
    """
    if inputs[0].device.type != "cuda":
        raise RuntimeError("run times the kernels on the card; the inputs "
                           "lie on {}".format(inputs[0].device))
    with torch.no_grad():
        calls = variant_calls(inputs, kind=kind, count=count)
        outs = {name: fn() for name, fn in calls}
        runs = time_calls(calls, reps, batch)
    mean0, var0 = outs["kernel1"]
    base = statistics.median(runs["kernel1"])
    results = {}
    for name, _ in calls:
        ms = statistics.median(runs[name])
        entry = {"ms": ms, "runs": runs[name]}
        if name != "kernel1":
            mean1, var1 = outs[name]
            dm = float((mean1 - mean0).abs().max())
            dv = float((var1 - var0).abs().max())
            entry.update(max_abs_mean_diff=dm, max_abs_var_diff=dv,
                         bitwise_identical=dm == 0.0 and dv == 0.0,
                         speedup=base / ms)
        results[name] = entry
    return results


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main(argv=None):
    """Time the variants on ``bench.py``'s GP on the card; one JSON line a
    variant."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pipelined_predict: needs an NVIDIA GPU")
    from ..config import config

    config.device = "cuda:0"
    print(card_line(), flush=True)
    gp = bench_gp()
    rng = np.random.default_rng(0)
    inputs = kernel_inputs(gp, rng.uniform(-1, 1, size=(args.points, 3)))
    results = run(inputs, reps=args.reps, count=gp.count)
    for name, entry in results.items():
        print(json.dumps(dict(entry, variant=name, points=args.points,
                              device=torch.cuda.get_device_name(0))),
              flush=True)
    return results


if __name__ == "__main__":
    main()
