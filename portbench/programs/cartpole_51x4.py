"""The port's instance of ``configs/cartpole_51x4.json``, as the JAX
repo's ``benchmarks/cartpole_51x4_sweep.py`` builds it: a
``GaussianProcess`` with an RBF covariance (kernel 1, d = 5, p = 4) and the
cart-pole's linearisation as prior mean, the fused whole-grid sweep."""

from __future__ import annotations

import numpy as np

import safe_learning_tpu_torch as st


def build(cfg, x, y, initial):
    """``Lyapunov`` over the configuration's grid with the GP of the data
    ``(x, y)`` (float32 rows) and the initial set ``initial`` (a mask)."""
    params = cfg["true_params"]
    system = st.CartPole(params["pendulum_mass"], params["cart_mass"],
                         params["length"], params["rot_friction"], cfg["dt"],
                         normalization=(cfg["state_scale"],
                                        cfg["action_scale"]))
    a, b = system.linearize()
    k, p = st.utils.dlqr(a, b, np.diag(cfg["lqr_q"]), np.diag(cfg["lqr_r"]))
    policy = st.Saturation(st.LinearSystem(-k), *cfg["action_limits"])
    p = p / np.abs(p).max()
    gp = st.GaussianProcess(
        st.RBF(cfg["gp_kernel_variance"], cfg["gp_lengthscales"],
               input_dim=5), x, y, noise_variance=cfg["gp_noise_variance"],
        beta=cfg["gp_beta"], mean_function=st.LinearSystem([a, b]),
        capacity=cfg["capacity"])
    grid = st.GridWorld(cfg["grid_limits"], cfg["grid_points"])
    lv = float(2 * np.linalg.norm(p, 2))
    lf = float(np.linalg.norm(a - b @ k, 2))
    tau = float(np.min(grid.unit_maxes)) * cfg["tau_edge_fraction"]
    return st.Lyapunov(grid, st.QuadraticFunction(p), gp, lf, lv, tau,
                       policy, initial_set=np.nonzero(initial)[0])
