"""Checkpoint and resume of safe-learning state, as ``npz`` files.

Counterpart of ``safe_learning_tpu/checkpoints.py``: a state is a tree of
dictionaries, lists and tuples whose leaves are tensors, arrays, numbers
and the GP kernels of :mod:`.functions.gp`; function parameters, GP data
buffers and hyperparameters, the safe set and the certified level are
such trees (:func:`lyapunov_state`, :func:`policy_iteration_state`).

The file holds one array per leaf under the key the JAX package writes
(``jax.tree_util.tree_flatten_with_path``, the path entries joined by
``/``), in its leaf order: dictionary keys sorted, each as ``['name']``;
list and tuple items as ``[i]``; a kernel's fields as ``[<flat index
i>]`` in the order of the JAX kernel's data fields; ``None`` holds no
leaf. So a checkpoint written by either package restores in the other.
Orbax, the JAX package's other format, is not ported.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from .config import config
from .functions.base import Function, as_tensor
from .functions.gp import GaussianProcess, Kernel, StackedGaussianProcess

__all__ = ["save_checkpoint", "restore_checkpoint", "lyapunov_state",
           "restore_lyapunov_state", "policy_iteration_state",
           "restore_policy_iteration_state"]

_NO_ORBAX = ("orbax checkpoints are not ported (ROADMAP queue 1 item 20: "
             "the port reads and writes npz only)")


def _kernel_fields(kernel):
    """A kernel's data fields in the JAX kernel's flattening order."""
    return tuple(kernel._leaf_fields) + tuple(kernel._child_fields)


def _children(node):
    """``(key, child)`` pairs of an inner node of a state tree, in the JAX
    package's leaf order, or ``None`` for a leaf."""
    if isinstance(node, dict):
        return [("[{!r}]".format(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [("[{}]".format(i), v) for i, v in enumerate(node)]
    if isinstance(node, Kernel):
        return [("[<flat index {}>]".format(i), getattr(node, name))
                for i, name in enumerate(_kernel_fields(node))]
    return None


def _as_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree):
    """``{key: array}`` of a state tree's leaves, in leaf order."""
    entries = {}

    def walk(node, path):
        if node is None:
            return
        children = _children(node)
        if children is None:
            entries["/".join(path)] = _as_numpy(node)
            return
        for key, child in children:
            walk(child, path + [key])

    walk(tree, [])
    return entries


def _unflatten(target, data):
    """A copy of ``target`` with every leaf read from ``data`` under its
    key. A tensor leaf comes back as a tensor of the target leaf's dtype
    and device, any other leaf as a numpy array; kernels are copied with
    their fields replaced."""
    def build(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, path + ["[{!r}]".format(k)])
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + ["[{}]".format(i)])
                              for i, v in enumerate(node))
        if isinstance(node, Kernel):
            new = copy.copy(node)
            for i, name in enumerate(_kernel_fields(node)):
                setattr(new, name, build(getattr(node, name), path + [
                    "[<flat index {}>]".format(i)]))
            return new
        value = np.asarray(data["/".join(path)])
        if torch.is_tensor(node):
            return torch.as_tensor(value, dtype=node.dtype,
                                   device=node.device)
        return value

    return build(target, [])


def save_checkpoint(path, state, use_orbax=False):
    """Save a state tree as an ``npz`` file.

    Parameters
    ----------
    path : str
        Target path (``.npz`` is appended when missing).
    state : tree of dicts, lists, tuples, tensors, arrays, numbers and
        kernels
    use_orbax : bool, optional
        Must be False: orbax is not ported.

    Returns the path written.
    """
    if use_orbax:
        raise NotImplementedError(_NO_ORBAX)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **_flatten_with_paths(state))
    return path


def restore_checkpoint(path, target):
    """Restore a checkpoint into the structure of ``target``.

    Reads ``path`` (or ``path + ".npz"``), written by :func:`save_checkpoint`
    or by the JAX package's, and returns ``target``'s tree with each leaf
    replaced by the saved array under its key (see :func:`_unflatten`). A
    path that is only an orbax directory raises ``NotImplementedError``.
    """
    if not path.endswith(".npz"):
        if not os.path.exists(path + ".npz") and os.path.isdir(path):
            raise NotImplementedError(_NO_ORBAX)
        path = path + ".npz"
    with np.load(path) as data:
        return _unflatten(target, data)


def _gp_state(gp):
    """A GP's data buffers and hyperparameters (the kernel's tensors
    included), with the JAX package's dtypes (``count`` int32)."""
    return {
        "X_buf": _as_numpy(gp.X_buf),
        "Y_buf": _as_numpy(gp.Y_buf),
        "count": np.asarray(gp.count, dtype=np.int32),
        "kernel": gp.kernel,
        "noise_variance": _as_numpy(gp.noise_variance),
        "beta": np.asarray(gp.beta, dtype=np.float64),
        "scale": np.asarray(gp.scale, dtype=np.float64),
    }


def _restore_gp(gp, state):
    """A GP rebuilt from saved data and hyperparameters (its factors
    refactorized on the host), with ``gp``'s prior mean."""
    count = int(state["count"])
    x_buf = np.asarray(state["X_buf"])
    kernel = state.get("kernel", gp.kernel)
    return GaussianProcess(
        kernel, x_buf[:count], np.asarray(state["Y_buf"])[:count],
        float(np.asarray(state.get("noise_variance",
                                   _as_numpy(gp.noise_variance)))),
        beta=float(state.get("beta", gp.beta)),
        mean_function=gp.mean_function, capacity=x_buf.shape[0],
        scale=float(state.get("scale", gp.scale)))


def _stacked_gp_state(gp):
    """A stacked GP's data buffers and hyperparameters."""
    return {
        "X_buf": _as_numpy(gp.X_buf),
        "Y_buf": _as_numpy(gp.Y_buf),
        "count": np.asarray(gp.count, dtype=np.int32),
        "kernels": list(gp.kernels),
        "noise_variances": _as_numpy(gp.noise_variances),
        "betas": np.asarray(gp.betas, dtype=np.float64),
        "scale": np.asarray(gp.scale, dtype=np.float64),
    }


def _restore_stacked_gp(gp, state):
    """A stacked GP rebuilt from saved state, with ``gp``'s prior means."""
    count = int(state["count"])
    x_buf = np.asarray(state["X_buf"])
    return StackedGaussianProcess(
        tuple(state.get("kernels", gp.kernels)), x_buf[:count],
        np.asarray(state["Y_buf"])[:count],
        np.asarray(state.get("noise_variances",
                             _as_numpy(gp.noise_variances))),
        betas=np.asarray(state.get("betas", gp.betas)),
        mean_functions=gp.mean_functions, capacity=x_buf.shape[0],
        scale=float(state.get("scale", gp.scale)))


def _dynamics_state(dynamics):
    """The GP part of a state: one GP, a stacked GP, or a
    ``FunctionStack`` of GPs."""
    if isinstance(dynamics, StackedGaussianProcess):
        return {"gp_stacked": _stacked_gp_state(dynamics)}
    if isinstance(dynamics, GaussianProcess):
        return {"gp": _gp_state(dynamics)}
    functions = getattr(dynamics, "functions", None)
    if functions and all(isinstance(f, GaussianProcess) for f in functions):
        return {"gp_stack": [_gp_state(f) for f in functions]}
    return {}


def _restore_dynamics(dynamics, state):
    if "gp_stacked" in state and isinstance(dynamics,
                                            StackedGaussianProcess):
        return _restore_stacked_gp(dynamics, state["gp_stacked"])
    if "gp" in state and isinstance(dynamics, GaussianProcess):
        return _restore_gp(dynamics, state["gp"])
    if "gp_stack" in state and hasattr(dynamics, "functions"):
        new = copy.copy(dynamics)
        new.functions = tuple(_restore_gp(f, s) for f, s in
                              zip(dynamics.functions, state["gp_stack"]))
        return new
    return dynamics


_LIPSCHITZ = (("lipschitz_lyapunov_parameters", "_lipschitz_lyapunov"),
              ("lipschitz_dynamics_parameters", "_lipschitz_dynamics"))


def lyapunov_state(lyapunov):
    """The persistent state of a :class:`~safe_learning_tpu_torch.Lyapunov`:
    safe set, ``c_max``, values, refinement levels, the parameters of the
    candidate, the policy and parameterized Lipschitz functions (a
    ``GradientNorm`` of the candidate: restoring the candidate alone would
    leave the thresholds at the old gradients), and the GP dynamics."""
    state = {
        "safe_set": np.asarray(lyapunov.safe_set),
        "c_max": np.asarray(lyapunov.c_max, dtype=np.float64),
        "values": _as_numpy(lyapunov.values),
        "refinement": np.asarray(lyapunov._refinement),
        "lyapunov_parameters": lyapunov.lyapunov_function.parameters_dict,
        "policy_parameters": lyapunov.policy.parameters_dict,
    }
    for name, attr in _LIPSCHITZ:
        fun = getattr(lyapunov, attr)
        if isinstance(fun, Function) and fun.parameters_dict:
            state[name] = fun.parameters_dict
    state.update(_dynamics_state(lyapunov.dynamics))
    return state


def restore_lyapunov_state(lyapunov, state):
    """Write a restored :func:`lyapunov_state` back onto ``lyapunov``:
    host state assigned, the values on ``config.device``, functions
    replaced by copies with the saved parameters, GPs rebuilt. Returns
    ``lyapunov``."""
    lyapunov.safe_set = np.asarray(state["safe_set"]).astype(bool)
    lyapunov.c_max = float(state["c_max"])
    lyapunov.values = as_tensor(np.asarray(state["values"]),
                                dtype=config.dtype)
    lyapunov._refinement = np.asarray(state["refinement"]).astype(int)
    if state.get("lyapunov_parameters"):
        lyapunov.lyapunov_function = \
            lyapunov.lyapunov_function.with_parameters(
                state["lyapunov_parameters"])
    if state.get("policy_parameters"):
        lyapunov.policy = lyapunov.policy.with_parameters(
            state["policy_parameters"])
    for name, attr in _LIPSCHITZ:
        fun = getattr(lyapunov, attr)
        if state.get(name) and isinstance(fun, Function):
            setattr(lyapunov, attr, fun.with_parameters(state[name]))
    lyapunov.dynamics = _restore_dynamics(lyapunov.dynamics, state)
    return lyapunov


def policy_iteration_state(rl):
    """The persistent state of a :class:`~safe_learning_tpu_torch.
    PolicyIteration`: the policy's and the value function's parameters,
    and the GP dynamics (one GP or a stacked GP)."""
    state = {
        "policy_parameters": rl.policy.parameters_dict,
        "value_parameters": rl.value_function.parameters_dict,
    }
    if isinstance(rl.dynamics, (GaussianProcess, StackedGaussianProcess)):
        state.update(_dynamics_state(rl.dynamics))
    return state


def restore_policy_iteration_state(rl, state):
    """Write a restored :func:`policy_iteration_state` back onto ``rl``;
    returns ``rl``."""
    if state.get("policy_parameters"):
        rl.policy = rl.policy.with_parameters(state["policy_parameters"])
    if state.get("value_parameters"):
        rl.value_function = rl.value_function.with_parameters(
            state["value_parameters"])
    if "gp_stack" not in state:
        rl.dynamics = _restore_dynamics(rl.dynamics, state)
    return rl
