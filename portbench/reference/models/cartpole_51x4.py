"""Plain reference of ``configs/cartpole_51x4.json``: the cart-pole
notebook's 51^4 verification grid.

The cart-pole, its linearisation ``[A, B]`` and LQR (``Q = diag(lqr_q)``,
``R = lqr_r``) with ``P / max|P|`` as the candidate and the saturated
policy, ``L_v = 2 |P|_2``, ``L_f = |A - B K|_2``, ``tau`` a fraction of the
smallest cell edge, and a GP with one RBF covariance shared by the four
state outputs and the linearisation as prior mean.
"""

from __future__ import annotations

import numpy as np

from .. import certify, dynamics, gp


def true_system(cfg):
    return dynamics.System(cfg["system"], cfg["true_params"], cfg["dt"],
                           cfg["state_scale"], cfg["action_scale"])


def design(cfg):
    """``(k, p, a, b)``: the policy gain, the candidate's matrix and the
    linearisation, float64."""
    a, b = true_system(cfg).linearize()
    k, p = dynamics.dlqr(a, b, np.diag(cfg["lqr_q"]), np.diag(cfg["lqr_r"]))
    return dict(k=k, p=p / np.abs(p).max(), a=a, b=b)


def initial_set(cfg, points):
    p = design(cfg)["p"]
    values = np.einsum("ij,jk,ik->i", points, p, points)
    return values <= np.quantile(values, cfg["initial_quantile"])


def model(cfg, x, y, prec):
    """The reference :class:`~..certify.Model` on the data ``(x, y)``."""
    d = design(cfg)
    prior = np.hstack([d["a"], d["b"]])
    kernel = gp.Stationary(cfg["gp_kernel"], cfg["gp_kernel_variance"],
                           cfg["gp_lengthscales"], list(range(5)))
    groups = [gp.GPGroup(kernel, cfg["gp_noise_variance"], cfg["gp_beta"],
                         [0, 1, 2, 3], prior)]
    limits = cfg["grid_limits"]
    num = [cfg["grid_points"]] * len(limits)
    tau = float(np.min(certify.unit_maxes(limits, num))
                * cfg["tau_edge_fraction"])
    return certify.Model(limits, num, d["p"], d["k"], cfg["action_limits"],
                         ("scalar", 2 * np.linalg.norm(d["p"], 2)),
                         np.linalg.norm(d["a"] - d["b"] @ d["k"], 2), tau,
                         gp.GP(groups, x, y, prec), prec,
                         refinement=cfg["max_refinement"],
                         sweep=cfg["sweep"])
