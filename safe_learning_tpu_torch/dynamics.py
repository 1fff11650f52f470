"""Benchmark dynamical systems: the inverted pendulum.

Counterpart of ``safe_learning_tpu/dynamics.py:26-157``: an ODE integrated
with a fixed number of inner Euler steps over a whole batch of states at
once, with optional state and action normalization, and the exact
zero-order-hold linearization from the ODE's Jacobian
(``torch.func.jacrev``) and ``scipy.signal.cont2discrete``.

Not ported yet: ``CartPole`` and ``VanDerPol`` (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.signal
import torch

from .config import config
from .functions.base import DeterministicFunction, as_tensor

__all__ = ["InvertedPendulum", "GRAVITY"]

GRAVITY = 9.81


class _OdeDynamics(DeterministicFunction):
    """Shared scaffolding: normalization and inner-Euler integration."""

    inner_euler_steps = 10

    def _norm_arrays(self):
        raise NotImplementedError

    def normalize(self, state, action=None):
        """Physical to normalized coordinates."""
        norm = self._norm_arrays()
        if norm is None:
            return state, action
        tx, tu = norm
        state = state / tx
        if action is not None and tu is not None:
            action = action / tu
        return state, action

    def denormalize(self, state, action=None):
        """Normalized to physical coordinates."""
        norm = self._norm_arrays()
        if norm is None:
            return state, action
        tx, tu = norm
        state = state * tx
        if action is not None and tu is not None:
            action = action * tu
        return state, action

    def evaluate(self, points):
        """Next state after ``dt``, from ``points = [state, action]``."""
        state = points[:, :self.state_dim]
        action = points[:, self.state_dim:]
        state, action = self.denormalize(state, action)
        dt = self.dt / self.inner_euler_steps
        for _ in range(self.inner_euler_steps):
            state = state + dt * self.ode(state, action)
        return self.normalize(state)[0]

    def linearize(self):
        """Discrete-time zero-order-hold linearization around the origin.

        The exact Jacobian of :meth:`ode` (``torch.func.jacrev``, in the
        working dtype on the CPU) through ``scipy.signal.cont2discrete``,
        as ``safe_learning_tpu/dynamics.py:65-102`` does with
        ``jax.jacobian``. Returns ``(A, B)`` as numpy arrays in the
        working dtype.
        """
        host = _on_cpu(self)
        x0 = torch.zeros(self.state_dim, dtype=config.dtype)
        u0 = torch.zeros(self.action_dim, dtype=config.dtype)

        def ode_flat(x, u):
            return host.ode(x[None, :], u[None, :])[0]

        a = torch.func.jacrev(ode_flat, argnums=0)(x0, u0).numpy()
        b = torch.func.jacrev(ode_flat, argnums=1)(x0, u0).numpy()

        norm = host._norm_arrays()
        if norm is not None:
            tx, tu = (t.numpy() for t in norm)
            a = np.diag(1.0 / tx) @ a @ np.diag(tx)
            b = np.diag(1.0 / tx) @ b @ np.diag(tu)

        ad, bd, _, _, _ = scipy.signal.cont2discrete(
            (a, b, np.zeros((1, self.state_dim)), 0), self.dt, method="zoh")
        return (ad.astype(config.np_dtype),
                bd[:, :self.action_dim].astype(config.np_dtype))

    def ode(self, state, action):
        """Continuous-time dynamics ``dx/dt`` at ``(state, action)``."""
        raise NotImplementedError


def _on_cpu(fun):
    """Shallow copy of ``fun`` with its tensors moved to the CPU."""
    new = copy.copy(fun)
    for name, value in vars(fun).items():
        if torch.is_tensor(value):
            setattr(new, name, value.detach().cpu())
    return new


class InvertedPendulum(_OdeDynamics):
    """Nonlinear inverted pendulum (``safe_learning_tpu.InvertedPendulum``).

    State ``(angle, angular velocity)``, action the torque. With
    ``normalization=(Tx, Tu)`` the dynamics act on normalized coordinates
    ``x = diag(Tx) x_norm``.
    """

    state_dim = 2
    action_dim = 1
    input_dim = 3
    output_dim = 2

    def __init__(self, mass, length, friction=0.0, dt=1 / 80,
                 normalization=None):
        self.mass = as_tensor(np.asarray(mass, dtype=config.np_dtype))
        self.length = as_tensor(np.asarray(length, dtype=config.np_dtype))
        self.friction = as_tensor(np.asarray(friction,
                                             dtype=config.np_dtype))
        self.dt = float(dt)
        if normalization is None:
            self.tx = self.tu = None
        else:
            tx, tu = normalization
            self.tx = as_tensor(np.asarray(tx, dtype=config.np_dtype)
                                .ravel())
            self.tu = as_tensor(np.asarray(tu, dtype=config.np_dtype)
                                .ravel())

    @property
    def inertia(self):
        """Total pendulum inertia about the pivot."""
        return self.mass * self.length ** 2

    def _norm_arrays(self):
        if self.tx is None:
            return None
        return self.tx, self.tu

    def ode(self, state, action):
        """Continuous-time dynamics ``dx/dt`` at ``(state, action)``."""
        angle = state[:, :1]
        angular_velocity = state[:, 1:]
        accel = (GRAVITY / self.length * torch.sin(angle)
                 + action / self.inertia
                 - self.friction / self.inertia * angular_velocity)
        return torch.cat((angular_velocity, accel), dim=1)
