"""Plain NumPy copies of the true systems and their LQR design.

The harness measures every data point with these (``traffic``), and the
reference models build their policy, candidate and Lipschitz constants
from them. Each system is its ODE in physical coordinates, integrated
with ten explicit Euler steps over ``dt`` in normalised coordinates, as
the upstream examples define them. The linearisation at the origin is
exact (complex-step derivatives), discretised by a zero-order hold (the
matrix exponential), and the LQR gain solves the discrete Riccati
equation by structure-preserving doubling: NumPy alone.
"""

from __future__ import annotations

import numpy as np

GRAVITY = 9.81
INNER_EULER_STEPS = 10


def pendulum_ode(params):
    """``dx/dt`` of the inverted pendulum ``(mass, length, friction)``;
    state ``(angle, angular velocity)``, action the torque."""
    mass, length, friction = params["mass"], params["length"], \
        params["friction"]
    inertia = mass * length ** 2

    def ode(state, action):
        angle, omega = state[:, 0:1], state[:, 1:2]
        accel = (GRAVITY / length * np.sin(angle) + action / inertia
                 - friction / inertia * omega)
        return np.concatenate([omega, accel], axis=1)

    return ode


def cartpole_ode(params):
    """``dx/dt`` of the cart-pole ``(pendulum_mass, cart_mass, length,
    rot_friction)``; state ``(x, theta, v, omega)``, action the force."""
    m, big_m = params["pendulum_mass"], params["cart_mass"]
    length, b = params["length"], params["rot_friction"]
    g = GRAVITY

    def ode(state, action):
        theta, v, omega = state[:, 1:2], state[:, 2:3], state[:, 3:4]
        sin_t, cos_t, sin_2t = np.sin(theta), np.cos(theta), \
            np.sin(2 * theta)
        det = length * (big_m + m * sin_t ** 2)
        v_dot = ((action - m * length * omega ** 2 * sin_t
                  - b * omega * cos_t + 0.5 * m * g * length * sin_2t)
                 * length / det)
        omega_dot = ((action * cos_t
                      - 0.5 * m * length * omega ** 2 * sin_2t
                      - b * (m + big_m) * omega / (m * length)
                      + (m + big_m) * g * sin_t) / det)
        return np.concatenate([v, omega, v_dot, omega_dot], axis=1)

    return ode


ODES = {"inverted_pendulum": pendulum_ode, "cart_pole": cartpole_ode}


class System:
    """A true system of a configuration: ``kind`` names its ODE,
    ``params`` its physical constants, ``dt`` the step and ``(tx, tu)``
    the normalisation (state and action scales)."""

    def __init__(self, kind, params, dt, tx, tu):
        self.ode = ODES[kind](params)
        self.dt = float(dt)
        self.tx = np.asarray(tx, dtype=np.float64).ravel()
        self.tu = np.asarray(tu, dtype=np.float64).ravel()
        self.state_dim = len(self.tx)
        self.action_dim = len(self.tu)

    def __call__(self, states, actions):
        """Next normalised states from normalised ``(states, actions)``."""
        x = np.asarray(states, dtype=np.float64) * self.tx
        u = np.asarray(actions, dtype=np.float64) * self.tu
        h = self.dt / INNER_EULER_STEPS
        for _ in range(INNER_EULER_STEPS):
            x = x + h * self.ode(x, u)
        return x / self.tx

    def linearize(self):
        """``(A, B)`` of the zero-order-hold discretisation of the ODE's
        Jacobian at the origin, in normalised coordinates."""
        n, m = self.state_dim, self.action_dim
        step = 1e-30
        jac = np.zeros((n, n + m))
        for j in range(n + m):
            z = np.zeros((1, n + m), dtype=np.complex128)
            z[0, j] = 1j * step
            jac[:, j] = np.imag(self.ode(z[:, :n], z[:, n:]))[0] / step
        a = np.diag(1 / self.tx) @ jac[:, :n] @ np.diag(self.tx)
        b = np.diag(1 / self.tx) @ jac[:, n:] @ np.diag(self.tu)
        block = np.zeros((n + m, n + m))
        block[:n, :n], block[:n, n:] = a, b
        e = expm(block * self.dt)
        return e[:n, :n], e[:n, n:]


def expm(mat):
    """Matrix exponential by scaling and squaring of a Taylor series."""
    norm = np.linalg.norm(mat, 1)
    squarings = max(0, int(np.ceil(np.log2(norm / 0.25))) if norm > 0
                    else 0)
    a = mat / 2.0 ** squarings
    term = np.eye(len(mat))
    out = term.copy()
    for k in range(1, 30):
        term = term @ a / k
        out = out + term
    for _ in range(squarings):
        out = out @ out
    return out


def dare(a, b, q, r, iterations=200):
    """The stabilising solution of the discrete algebraic Riccati
    equation by structure-preserving doubling."""
    n = len(a)
    g = b @ np.linalg.solve(r, b.T)
    h = np.array(q, dtype=np.float64)
    a_k = np.array(a, dtype=np.float64)
    for _ in range(iterations):
        w = np.linalg.inv(np.eye(n) + g @ h)
        a_next = a_k @ w @ a_k
        g_next = g + a_k @ w @ g @ a_k.T
        h_next = h + a_k.T @ h @ w @ a_k
        done = np.linalg.norm(h_next - h) <= 1e-15 * np.linalg.norm(h_next)
        a_k, g, h = a_next, 0.5 * (g_next + g_next.T), \
            0.5 * (h_next + h_next.T)
        if done:
            break
    return h


def dlqr(a, b, q, r):
    """LQR gain ``k`` (``u = -k x``) and Riccati matrix ``p``."""
    a, b, q, r = (np.atleast_2d(np.asarray(m, dtype=np.float64))
                  for m in (a, b, q, r))
    p = dare(a, b, q, r)
    bp = b.T @ p
    return np.linalg.solve(bp @ b + r, bp @ a), p
