"""Kernel 1 with the squared distance in the expanded form, timed beside it.

Counterpart of ``benchmarks/distance_mxu_experiment.py``, whose Pallas
kernel (``_kernel_mxu`` ``:30``) forms ``r^2 = max(xx - 2 x^T q + qq, 0)``
with the cross term on the TPU's matrix unit, and ``L^-1 K`` there too.
Here ``fused_predict_mxu_dist`` is a hand-written CUDA kernel for Hopper
(``csrc/gp_predict_variants.cu``, ``gp_expanded``). In float32, up to 128
rows, both products run on the tensor cores in three TF32 passes
(``wgmma``; each operand split into two TF32 halves, ``small big + big
small + big big`` into an FP32 accumulator), ``xx`` and ``qq`` in float32
on the CUDA cores: not IEEE float32, so the kernel stays off every path
of the package, and ``chip_smoke.expanded_bounds(..., tf32x3=True)``
bounds it. In float64, and above 128 rows, the cross term is d FMAs in
the working precision on the CUDA cores. The expanded form cancels near
``r^2 = 0``; the clamp keeps ``r^2 >= 0``.

``fused_predict_mxu_dist`` keeps the JAX signature: ``tile`` and
``precision`` (the TPU's block width and matrix-unit pass) are accepted
and unused, ``count`` bounds the kernel's loops as in kernel 1. A CPU
tensor goes to the plain version (:func:`fused_predict_mxu_dist_plain`,
the same expanded form and clamp), a CUDA tensor to the kernel or the
call raises. Forward only: inputs that require a gradient raise.

``run`` times kernel 1 and the expanded kernel in turns and reports the
JAX script's measure (``:102-144``): milliseconds per 10^6 predicts and
the largest ``|mean - mean_f64|`` over the first 4,096 queries against a
float64 oracle on the host. On a machine with the card::

    python -m safe_learning_tpu_torch.benchmarks.distance_mxu_experiment

builds that script's instance (128 points in [-1, 1]^3, RBF with variance
1 and lengthscales 0.3, noise 1e-6, 2^20 queries) and runs it.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops.gp_kernel import fused_gp_predict, gp_predict_plain
from .pipelined_predict import (_forward_only, card_line, kernel_inputs,
                                launch_variant, time_calls)

__all__ = ["fused_predict_mxu_dist", "fused_predict_mxu_dist_plain",
           "fused_predict_mxu_dist_cuda", "expanded_sq_dist", "run",
           "main"]

PRECISIONS = ("highest", "high")


def expanded_sq_dist(points_scaled, x_scaled):
    """``max(xx - 2 x q^T + qq, 0)``, ``(cap, Q)``: the JAX body's r^2."""
    xx = (x_scaled * x_scaled).sum(dim=1)
    qq = (points_scaled * points_scaled).sum(dim=1)
    cross = torch.matmul(x_scaled, points_scaled.T)
    return torch.clamp(xx[:, None] - 2.0 * cross + qq[None, :], min=0.0)


def fused_predict_mxu_dist_plain(points_scaled, x_scaled, chol_inv, alpha,
                                 mask, kernel_variance_s2, kind="rbf",
                                 count=None):
    """Plain PyTorch version: kernel 1's function with r^2 in the expanded
    form (:func:`expanded_sq_dist`); ``count`` ignored (full capacity)."""
    from ..functions.gp import STATIONARY_COVARIANCES

    k = (STATIONARY_COVARIANCES[kind](expanded_sq_dist(points_scaled,
                                                       x_scaled))
         * kernel_variance_s2 * mask[:, None])
    a = torch.matmul(chol_inv, k)
    return torch.matmul(a.T, alpha), (a * a).sum(dim=0)


def fused_predict_mxu_dist_cuda(points_scaled, x_scaled, chol_inv, alpha,
                                mask, kernel_variance_s2, kind="rbf",
                                count=None):
    """Launch the expanded-distance kernel (contract and precondition of
    :func:`~safe_learning_tpu_torch.ops.gp_kernel.gp_predict_cuda`)."""
    return launch_variant("gp_expanded", fused_predict_mxu_dist_cuda,
                          points_scaled, x_scaled, chol_inv, alpha, mask,
                          kernel_variance_s2, kind, count)


#: Kernel launches since the last reset (``chip_smoke.py`` resets it).
fused_predict_mxu_dist_cuda.launches = 0


def fused_predict_mxu_dist(points_scaled, x_scaled, chol_inv, alpha, mask,
                           kernel_variance_s2, kind="rbf", tile=4096,
                           precision="highest", count=None):
    """Kernel 1's outputs with r^2 in the expanded form.

    ``tile`` and ``precision`` (``"highest"`` or ``"high"``, the TPU's
    matrix-unit passes) are accepted and unused: on the card the float32
    kernel takes three TF32 passes whatever ``precision`` says.
    """
    if precision not in PRECISIONS:
        raise ValueError("precision must be one of {}, got {!r}".format(
            PRECISIONS, precision))
    _forward_only(points_scaled, x_scaled, chol_inv, alpha, mask,
                  kernel_variance_s2)
    if points_scaled.device.type == "cpu":
        return fused_predict_mxu_dist_plain(points_scaled, x_scaled,
                                            chol_inv, alpha, mask,
                                            kernel_variance_s2, kind=kind,
                                            count=count)
    return fused_predict_mxu_dist_cuda(points_scaled, x_scaled, chol_inv,
                                       alpha, mask, kernel_variance_s2,
                                       kind=kind, count=count)


def oracle_mean(inputs, kind="rbf", queries=4096):
    """Float64 mean numerators of the first ``queries`` queries on the
    host, by per-dimension differences (kernel 1's plain math)."""
    host = [torch.as_tensor(t).detach().to("cpu", torch.float64)
            for t in inputs]
    host[0] = host[0][:queries]
    return gp_predict_plain(*host, kind=kind)[0]


def run(inputs, reps=5, kind="rbf", count=None, batch=10, queries=4096):
    """Time kernel 1 and the expanded-distance kernel in turns on one set
    of kernel inputs on the card, and take each one's error against the
    float64 oracle (:func:`oracle_mean`) on the first ``queries`` queries.

    Returns, per name (``"kernel1"``, ``"expanded"``): the median ``ms`` of
    a call and every round's (``runs``), ``ms_per_1m`` (per 10^6
    predicts), ``max_abs_err_vs_f64`` and ``pts_per_s``.
    """
    if inputs[0].device.type != "cuda":
        raise RuntimeError("run times the kernels on the card; the inputs "
                           "lie on {}".format(inputs[0].device))
    n_q = inputs[0].shape[0]
    with torch.no_grad():
        calls = [("kernel1", lambda: fused_gp_predict(*inputs, kind=kind,
                                                      count=count)),
                 ("expanded", lambda: fused_predict_mxu_dist(
                     *inputs, kind=kind, count=count))]
        outs = {name: fn()[0] for name, fn in calls}
        runs = time_calls(calls, reps, batch)
    ref = oracle_mean(inputs, kind=kind, queries=queries)
    results = {}
    for name, _ in calls:
        ms = statistics.median(runs[name])
        err = float((outs[name][:queries].to("cpu", torch.float64)
                     - ref).abs().max())
        results[name] = {"ms": ms, "runs": runs[name],
                         "ms_per_1m": ms * 1e6 / n_q,
                         "pts_per_s": n_q / (ms * 1e-3),
                         "max_abs_err_vs_f64": err}
    return results


def experiment_gp():
    """The JAX script's instance: 128 points uniform in [-1, 1]^3, two
    outputs, RBF with variance 1 and lengthscales 0.3, noise 1e-6; and the
    numpy generator after drawing them, for the queries."""
    from .. import GaussianProcess, RBF

    rng = np.random.default_rng(0)
    x_train = rng.uniform(-1, 1, size=(128, 3))
    y_train = np.column_stack([np.sin(x_train @ [1.0, 0.5, 0.2]),
                               np.cos(x_train @ [0.3, -0.7, 0.1])])
    gp = GaussianProcess(RBF(1.0, [0.3, 0.3, 0.3], input_dim=3), x_train,
                         y_train, noise_variance=1e-6)
    return gp, rng


def main(argv=None):
    """Run the experiment on the card; one JSON line a kernel."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("distance_mxu_experiment: needs an NVIDIA GPU")
    from ..config import config

    config.device = "cuda:0"
    print(card_line(), flush=True)
    gp, rng = experiment_gp()
    inputs = kernel_inputs(gp, rng.uniform(-1, 1, size=(args.points, 3)))
    results = run(inputs, reps=args.reps, count=gp.count)
    for name, entry in results.items():
        print(json.dumps(dict(entry, kernel=name, points=args.points,
                              device=torch.cuda.get_device_name(0))),
              flush=True)
    return results


if __name__ == "__main__":
    main()
