"""Plain reference of ``configs/pendulum_adaptive.json``: the adaptive
safety verification example's inverted pendulum.

The true pendulum and the model's, their linearisations, the true
model's LQR (``Q = diag(lqr_q)``, ``R = lqr_r``) with ``P / max|P|`` as
the candidate and the saturated policy, ``L_v(x) = |2 P x|``, ``L_f =
|A_true|_1 + |B_true|_1 |K|_1``, ``tau`` half the sum of a grid cell's
edges, and per state dimension a GP ``Linear(var) + Matern32(dim 0) *
Linear(dim 0, var[1])`` with the model's linearisation as prior mean and
``var = (true - model)^2`` clipped at ``gp_prior_variance_min``.
"""

from __future__ import annotations

import numpy as np

from .. import certify, dynamics, gp


def _system(cfg, params):
    return dynamics.System(cfg["system"], params, cfg["dt"],
                           cfg["state_scale"], cfg["action_scale"])


def true_system(cfg):
    return _system(cfg, cfg["true_params"])


def design(cfg):
    """``(k, p, a_true, b_true, a, b)``: the policy gain, the candidate's
    matrix and both linearisations, float64."""
    a_true, b_true = true_system(cfg).linearize()
    a, b = _system(cfg, cfg["model_params"]).linearize()
    k, p = dynamics.dlqr(a_true, b_true, np.diag(cfg["lqr_q"]),
                         np.diag(cfg["lqr_r"]))
    return dict(k=k, p=p / np.abs(p).max(), a_true=a_true, b_true=b_true,
                a=a, b=b)


def initial_set(cfg, points):
    return np.linalg.norm(points, axis=1) <= cfg["initial_radius"]


def model(cfg, x, y, prec):
    """The reference :class:`~..certify.Model` on the data ``(x, y)``."""
    d = design(cfg)
    truth = np.hstack([d["a_true"], d["b_true"]])
    wrong = np.hstack([d["a"], d["b"]])
    variances = np.clip((truth - wrong) ** 2,
                        cfg["gp_prior_variance_min"], None)
    groups = [gp.GPGroup(
        gp.Sum(gp.Linear(variances[s], [0, 1, 2]),
               gp.Product(gp.Stationary("matern32", 1.0, 1.0, [0]),
                          gp.Linear(variances[s][1], [0]))),
        cfg["gp_noise_variance"], cfg["gp_beta"], [s], wrong[s])
        for s in range(2)]
    k = d["k"]
    lf = (np.linalg.norm(d["a_true"], 1)
          + np.linalg.norm(d["b_true"], 1) * np.linalg.norm(k, 1))
    limits = cfg["grid_limits"]
    num = [cfg["grid_points"]] * len(limits)
    tau = float(np.sum(certify.unit_maxes(limits, num)) / 2)
    return certify.Model(limits, num, d["p"], k, cfg["action_limits"],
                         ("local", 2 * d["p"]), lf, tau,
                         gp.GP(groups, x, y, prec), prec,
                         refinement=cfg["max_refinement"],
                         sweep=cfg["sweep"])
