"""The port's instance of ``configs/pendulum_adaptive.json``, as the
port's ``examples/adaptive_safety_verification.py`` builds it: the wrong
pendulum's linearisation as the prior mean of a ``StackedGaussianProcess``
(kernel 3), the true pendulum's LQR, ``Lyapunov(adaptive=True)``."""

from __future__ import annotations

import numpy as np

import safe_learning_tpu_torch as st
from safe_learning_tpu_torch.examples.adaptive_safety_verification import (
    AbsoluteValue)
from safe_learning_tpu_torch.examples.inverted_pendulum import (
    pendulum_kernel)


def _pendulum(cfg, params):
    return st.InvertedPendulum(
        params["mass"], params["length"], params["friction"], cfg["dt"],
        normalization=(cfg["state_scale"], cfg["action_scale"]))


def build(cfg, x, y, initial):
    """``Lyapunov`` over the configuration's grid with the GP of the data
    ``(x, y)`` (float32 rows) and the initial set ``initial`` (a mask)."""
    a_true, b_true = _pendulum(cfg, cfg["true_params"]).linearize()
    a, b = _pendulum(cfg, cfg["model_params"]).linearize()
    variances = np.clip((np.hstack([a_true, b_true]) - np.hstack([a, b]))
                        ** 2, cfg["gp_prior_variance_min"], None)
    gp = st.StackedGaussianProcess(
        [pendulum_kernel(variances[s]) for s in range(2)], x, y,
        noise_variances=[cfg["gp_noise_variance"]] * 2,
        betas=cfg["gp_beta"],
        mean_functions=[st.LinearSystem([a[[s]], b[[s]]]) for s in range(2)],
        capacity=cfg["capacity"])
    grid = st.GridWorld(cfg["grid_limits"], cfg["grid_points"])
    tau = float(np.sum(grid.unit_maxes) / 2)
    k, p = st.utils.dlqr(a_true, b_true, np.diag(cfg["lqr_q"]),
                         np.diag(cfg["lqr_r"]))
    p = p / np.abs(p).max()
    policy = st.Saturation(st.LinearSystem(-k), *cfg["action_limits"])
    lf = (np.linalg.norm(a_true, 1)
          + np.linalg.norm(b_true, 1) * np.linalg.norm(-k, 1))
    lv = AbsoluteValue(st.LinearSystem([2 * p]))
    return st.Lyapunov(grid, st.QuadraticFunction(p), gp, lf, lv, tau,
                       policy, initial_set=np.nonzero(initial)[0],
                       adaptive=True)
