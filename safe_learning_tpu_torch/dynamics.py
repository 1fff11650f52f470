"""Benchmark dynamical systems: inverted pendulum, cart-pole, Van der Pol.

Counterpart of ``safe_learning_tpu/dynamics.py``: an ODE integrated with a
fixed number of inner Euler steps over a whole batch of states at once,
with optional state and action normalization, and the exact
zero-order-hold linearization from the ODE's Jacobian
(``torch.func.jacrev``) and ``scipy.signal.cont2discrete``.
"""

from __future__ import annotations

import copy

import numpy as np
import scipy.signal
import torch

from .config import config
from .functions.base import DeterministicFunction, as_tensor

__all__ = ["InvertedPendulum", "CartPole", "VanDerPol", "GRAVITY"]

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
        ode = self._integrand()
        for _ in range(self.inner_euler_steps):
            state = state + dt * ode(state, action)
        return self.normalize(state)[0]

    def _integrand(self):
        """The ODE as a function of ``(state, action)``, made once per
        :meth:`evaluate` for all its inner Euler steps."""
        return self.ode

    def linearize(self):
        """Discrete-time zero-order-hold linearization around the origin.

        The exact Jacobian of :meth:`ode` (``torch.func.jacrev``, in the
        working dtype on the CPU) through ``scipy.signal.cont2discrete``,
        as ``safe_learning_tpu/dynamics.py:65-102`` does with
        ``jax.jacobian``. Returns ``(A, B)`` as numpy arrays in the
        working dtype, or ``A`` alone for a system without an action.
        """
        host = _on_cpu(self)
        x0 = torch.zeros(self.state_dim, dtype=config.dtype)
        u0 = torch.zeros(self.action_dim, dtype=config.dtype)

        def ode_flat(x, u):
            return host.ode(x[None, :], u[None, :])[0]

        a = torch.func.jacrev(ode_flat, argnums=0)(x0, u0).numpy()
        if self.action_dim:
            b = torch.func.jacrev(ode_flat, argnums=1)(x0, u0).numpy()
        else:
            b = np.zeros((self.state_dim, 1))

        norm = host._norm_arrays()
        if norm is not None:
            tx, tu = norm
            tx = tx.numpy()
            a = np.diag(1.0 / tx) @ a @ np.diag(tx)
            if tu is not None and self.action_dim:
                b = np.diag(1.0 / tx) @ b @ np.diag(tu.numpy())

        ad, bd, _, _, _ = scipy.signal.cont2discrete(
            (a, b, np.zeros((1, self.state_dim)), 0), self.dt, method="zoh")
        if self.action_dim:
            return (ad.astype(config.np_dtype),
                    bd[:, :self.action_dim].astype(config.np_dtype))
        return ad.astype(config.np_dtype)

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
        self.tx, self.tu = _normalization(normalization)

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


def _normalization(normalization):
    """``(tx, tu)`` tensors of a ``(Tx, Tu)`` normalization, or Nones."""
    if normalization is None:
        return None, None
    tx, tu = normalization
    return (as_tensor(np.asarray(tx, dtype=config.np_dtype).ravel()),
            as_tensor(np.asarray(tu, dtype=config.np_dtype).ravel()))


class CartPole(_OdeDynamics):
    """Cart-mounted inverted pendulum (``safe_learning_tpu.CartPole``).

    State ``(x, theta, v, omega)``, action the horizontal force on the
    cart; the ODE of ``safe_learning_tpu/dynamics.py:197-220`` term by
    term.
    """

    state_dim = 4
    action_dim = 1
    input_dim = 5
    output_dim = 4

    def __init__(self, pendulum_mass, cart_mass, length, rot_friction=0.0,
                 dt=0.01, normalization=None):
        def scalar(value):
            return as_tensor(np.asarray(value, dtype=config.np_dtype))

        self.pendulum_mass = scalar(pendulum_mass)
        self.cart_mass = scalar(cart_mass)
        self.length = scalar(length)
        self.rot_friction = scalar(rot_friction)
        self.dt = float(dt)
        self.tx, self.tu = _normalization(normalization)

    def _norm_arrays(self):
        if self.tx is None:
            return None
        return self.tx, self.tu

    def ode(self, state, action):
        """Continuous-time dynamics ``dx/dt`` at ``(state, action)``."""
        return self._integrand()(state, action)

    def _integrand(self):
        # The products of parameters alone are taken once per evaluate,
        # not once per inner step: each is a device launch, a quarter of
        # the ODE's. Each keeps its place in the JAX package's left-to-right
        # products, so values and gradients are the same to the bit.
        m = self.pendulum_mass
        big_m = self.cart_mass
        length = self.length
        b = self.rot_friction
        g = GRAVITY
        m_length = m * length
        half_mgl = 0.5 * m * g * length
        half_ml = 0.5 * m * length
        friction = b * (m + big_m)
        weight = (m + big_m) * g

        def ode(state, action):
            theta = state[:, 1:2]
            v = state[:, 2:3]
            omega = state[:, 3:4]

            sin_t = torch.sin(theta)
            cos_t = torch.cos(theta)
            sin_2t = torch.sin(2 * theta)
            det = length * (big_m + m * sin_t ** 2)
            v_dot = ((action - m_length * omega ** 2 * sin_t
                      - b * omega * cos_t
                      + half_mgl * sin_2t) * length / det)
            omega_dot = ((action * cos_t
                          - half_ml * omega ** 2 * sin_2t
                          - friction * omega / m_length
                          + weight * sin_t) / det)
            return torch.cat((v, omega, v_dot, omega_dot), dim=1)

        return ode


class VanDerPol(_OdeDynamics):
    """Van der Pol oscillator in reverse time, uncontrolled
    (``safe_learning_tpu.VanDerPol``). ``normalization`` is the state
    scale ``Tx`` alone; :meth:`linearize` returns one matrix."""

    state_dim = 2
    action_dim = 0
    input_dim = 2
    output_dim = 2

    def __init__(self, damping=1.0, dt=0.01, normalization=None):
        self.damping = as_tensor(np.asarray(damping, dtype=config.np_dtype))
        self.dt = float(dt)
        self.tx = (None if normalization is None else as_tensor(
            np.asarray(normalization, dtype=config.np_dtype).ravel()))

    def _norm_arrays(self):
        if self.tx is None:
            return None
        return self.tx, None

    def ode(self, state, action):
        """Continuous-time dynamics ``dx/dt`` at ``(state, action)``."""
        del action  # uncontrolled system
        x = state[:, :1]
        y = state[:, 1:]
        x_dot = -y
        y_dot = x + self.damping * (x ** 2 - 1) * y
        return torch.cat((x_dot, y_dot), dim=1)
