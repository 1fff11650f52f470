"""Shared helpers for the parity tests of the PyTorch port.

Every parity test builds one instance from numpy data in both packages
and compares the outputs as numpy arrays. Tier-1 runs several pytest
workers at once, so torch is held to one intra-op thread here.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

import safe_learning_tpu as sl
import safe_learning_tpu_torch as st
from safe_learning_tpu_torch import convert

torch.set_num_threads(1)

KINDS = {"rbf": (sl.RBF, st.RBF), "matern12": (sl.Matern12, st.Matern12),
         "matern32": (sl.Matern32, st.Matern32),
         "matern52": (sl.Matern52, st.Matern52)}


@contextlib.contextmanager
def working_dtype(name):
    """Set both packages' working dtype (``"float32"`` or ``"float64"``).

    The tests' conftest turns JAX's x64 mode on, so float32 cases set the
    JAX package's dtype explicitly; both settings are restored after.
    """
    jax_old, port_old = sl.config._dtype, st.config.dtype
    sl.config.dtype = getattr(jnp, name)
    st.config.dtype = getattr(torch, name)
    try:
        yield
    finally:
        sl.config._dtype = jax_old
        st.config.dtype = port_old


def to_numpy(value):
    """Numpy copy of a JAX array or a torch tensor."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def port_kernel(kernel):
    """The port's copy of a JAX stationary kernel."""
    kind = {cls: name for name, (cls, _) in KINDS.items()}[type(kernel)]
    return convert.stationary_kernel(kind, np.asarray(kernel.variance),
                                     np.asarray(kernel.lengthscales))


def port_gp(gp, adopt=False):
    """The port's copy of a JAX GP with a ``LinearSystem`` or no prior.

    ``adopt=True`` feeds the port the JAX GP's own cache.
    """
    mean = (None if gp.mean_function is None
            else convert.linear_system(np.asarray(gp.mean_function.matrix)))
    cache = None
    if adopt:
        cache = dict(chol_inv=np.asarray(gp.chol_inv),
                     alpha=np.asarray(gp.alpha),
                     X_buf=np.asarray(gp.X_buf), count=int(gp.count))
    return convert.gaussian_process(
        port_kernel(gp.kernel), gp.X, gp.Y, float(gp.noise_variance),
        beta=gp.beta, scale=gp.scale, capacity=gp.capacity,
        mean_function=mean, adopt=cache)


def jax_bench_lyapunov(n_points):
    """``bench.py``'s instance in the JAX package, with its raw data."""
    from bench import _build_instance

    (grid, policy, v, lv, lf, gp, tau, initial_set, a, x_train, y_train,
     params) = _build_instance(n_points=n_points)
    lyap = sl.Lyapunov(grid, v, gp, lf, lv, tau, policy,
                       initial_set=initial_set)
    return lyap, dict(a=a, x_train=x_train, y_train=y_train, params=params,
                      lf=lf, tau=tau, initial_set=initial_set)


def port_bench_lyapunov(n_points):
    """``bench.py``'s instance in the port, from
    ``chip_smoke.build_bench_instance``."""
    from chip_smoke import build_bench_instance

    inst = build_bench_instance(n_points)
    lyap = st.Lyapunov(inst["grid"], inst["v"], inst["gp"], inst["lf"],
                       inst["lv"], inst["tau"], inst["policy"],
                       initial_set=inst["initial_set"])
    return lyap, inst
