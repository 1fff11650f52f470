"""Approximate dynamic programming and safe policy iteration.

Counterpart of ``safe_learning_tpu/rl.py``, with its departures from the
TF reference:

- ``optimize_value_function`` solves the piecewise-linear value function
  exactly as the fixed point of the contraction ``v = r + gamma B v``
  (``B``: barycentric interpolation weights, non-negative rows summing to
  one), the solution of the reference's LP, by a gather-weighted sum on
  the device; ``OptimizationError`` is raised when it does not converge;
- ``discrete_policy_optimization`` evaluates the whole action space in one
  batched call;
- ``optimize_policy`` runs plain SGD on the policy's trainable parameters
  (``parameters_dict``) only.

The JAX package compiles each loop into one program. Here the loops are
eager PyTorch on ``config.device``, and the host waits for the device
only where a loop has to decide whether to stop: once per block of
fixed-point iterations, once per outer policy iteration, and once at the
end of an ascent for its losses.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
from .functions.base import Function, as_deterministic, as_tensor
from .lyapunov import _decrease_bound, _threshold
from .utils import _tree_leaves, _tree_map

__all__ = ["PolicyIteration", "OptimizationError"]

#: Fixed-point iterations between two host checks of the stopping flag.
FIXED_POINT_BLOCK = 64


class OptimizationError(Exception):
    """Raised when the value-function solve fails."""


def _future_values_core(policy, dynamics, reward_function, value_function,
                        gamma, states, actions):
    """``r + gamma * v(f(x, u))``; an uncertain model contributes its
    mean."""
    if actions is None:
        actions = policy(states)
    next_states = dynamics(states, actions)
    rewards = reward_function(states, actions).reshape(-1, 1)
    if isinstance(next_states, (tuple, list)):
        next_states, _ = next_states
    expected = value_function(next_states).reshape(-1, 1)
    return rewards + gamma * expected


def _future_values_lyapunov(policy, dynamics, reward_function,
                            value_function, gamma, states, actions,
                            lyapunov_function, lipschitz_lyapunov,
                            lipschitz_dynamics, tau, lagrange_multiplier):
    """Future values less ``lagrange_multiplier`` times the Lyapunov
    decrease constraint ``decrease bound - threshold``."""
    if actions is None:
        actions = policy(states)
    next_states = dynamics(states, actions)
    rewards = reward_function(states, actions).reshape(-1, 1)
    decrease = _decrease_bound(lyapunov_function, lipschitz_lyapunov,
                               states, next_states)
    if isinstance(next_states, (tuple, list)):
        next_states, _ = next_states
    expected = value_function(next_states).reshape(-1, 1)
    updated = rewards + gamma * expected
    constraint = decrease - _threshold(lipschitz_lyapunov,
                                       lipschitz_dynamics, states, tau)
    return updated - lagrange_multiplier * constraint


def _uniform_minibatch(generator, batch_size, lo, hi):
    """``batch_size`` states uniform in the box ``[lo, hi]``, drawn on the
    device."""
    u = torch.rand((batch_size, lo.shape[0]), generator=generator,
                   dtype=lo.dtype, device=lo.device)
    return lo + (hi - lo) * u


def _sgd_step(loss_fn, params, learning_rate):
    """One step ``w - learning_rate * grad`` on a parameter tree.

    The gradient is taken at leaf copies of the parameters; the returned
    tree holds detached tensors. Returns ``(params, loss)``, the loss
    detached on the device.
    """
    leaves = _tree_map(lambda w: w.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(leaves)
        flat = _tree_leaves(leaves)
        grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    with torch.no_grad():
        new = _tree_map(lambda w: w - learning_rate * grads[id(w)], leaves)
    return new, loss.detach()


def _policy_ascent(policy, params, dynamics, reward_function,
                   value_function, gamma, lyap, learning_rate, draw, *,
                   steps):
    """Policy-gradient ascent on the mean future value.

    ``draw(step)`` gives each step's minibatch of states. Only the
    policy's trainable parameters (``params``, its ``parameters_dict``)
    move; structural leaves such as ``Saturation`` bounds stay fixed.
    ``lyap`` is ``None`` or the tuple ``(lyapunov_function,
    lipschitz_lyapunov, lipschitz_dynamics, tau, lagrange_multiplier)``.
    Returns ``(params, losses)``: the final parameters, detached, and the
    per-step losses as a tensor on the device.
    """
    losses = []
    for step in range(steps):
        states = draw(step)

        def loss(pp):
            pol = policy.with_parameters(pp)
            if lyap is None:
                return -torch.mean(_future_values_core(
                    pol, dynamics, reward_function, value_function, gamma,
                    states, None))
            return -torch.mean(_future_values_lyapunov(
                pol, dynamics, reward_function, value_function, gamma,
                states, None, *lyap))

        params, value = _sgd_step(loss, params, learning_rate)
        losses.append(value)
    return params, torch.stack(losses) if losses else torch.empty(0)


def _pwl_fixed_point(vertices, weights, rewards, gamma, init_values, tol,
                     max_iter, block=FIXED_POINT_BLOCK):
    """Solve ``v = r + gamma * B v`` on the device.

    ``B`` is the sparse barycentric interpolation operator given as
    ``(vertices, weights)``, ``ndim + 1`` entries per row: the matvec is a
    gather and a weighted sum, never a dense matrix. ``tol`` is relative
    to ``max(1, max|v|)``. The iteration stops at the first iterate with
    ``delta <= tol``, or after ``max_iter`` iterations, as the JAX
    package's ``lax.while_loop``: the host checks a device flag every
    ``block`` iterations, and once the flag is set the iterate, ``delta``
    and the count stay frozen. Returns ``(values, delta, iterations)`` as
    device tensors, ``delta`` scaled.
    """
    v = init_values
    delta = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    iterations = torch.zeros((), dtype=torch.int64, device=v.device)
    done = torch.zeros((), dtype=torch.bool, device=v.device)
    tol = torch.as_tensor(tol, dtype=v.dtype, device=v.device)
    run = 0
    while run < max_iter:
        for _ in range(min(block, max_iter - run)):
            bv = (weights * v[vertices, 0]).sum(dim=1, keepdim=True)
            v_new = rewards + gamma * bv
            scale = v_new.abs().max().clamp(min=1.0)
            d = (v_new - v).abs().max() / scale
            v = torch.where(done, v, v_new)
            delta = torch.where(done, delta, d)
            iterations = iterations + (~done).to(iterations.dtype)
            # The JAX loop continues while delta > tol: a NaN stops it.
            done = done | ~(delta > tol)
        run += block
        if bool(done):
            break
    return v, delta, iterations


def _default_tol(dtype):
    return 1e-9 if dtype == torch.float64 else 1e-5


def _require_parameters(policy):
    params = policy.parameters_dict
    if not params:
        raise ValueError(
            "policy has no trainable parameters (parameters_dict is "
            "empty) — wrap it in a parameterized Function")
    return params


class PolicyIteration:
    """Safe approximate policy iteration.

    Parameters
    ----------
    policy : Function
    dynamics : Function
    reward_function : Function or callable
    value_function : Triangulation (or any DeterministicFunction with a
        ``discretization`` and ``interpolation_weights``)
    gamma : float
        Discount factor.
    """

    def __init__(self, policy, dynamics, reward_function, value_function,
                 gamma=0.98):
        self.policy = as_deterministic(policy)
        self.dynamics = dynamics if isinstance(dynamics, Function) \
            else as_deterministic(dynamics)
        self.reward_function = as_deterministic(reward_function)
        self.value_function = value_function
        self.gamma = float(gamma)
        self.state_space = as_tensor(value_function.discretization.all_points)
        self._generator = None
        # Minibatch source of optimize_policy: (generator, batch_size, lo,
        # hi) -> states. The tests replace it to feed given minibatches.
        self._draw_minibatch = _uniform_minibatch
        #: ``(iterations, delta)`` of the last value solve.
        self._last_solve = None

    # ------------------------------------------------------------------
    def future_values(self, states, policy=None, actions=None,
                      lyapunov=None, lagrange_multiplier=1.0):
        """Expected one-step lookahead values ``r + gamma v(f(x, u))``,
        ``(N, 1)``; with ``lyapunov``, less ``lagrange_multiplier`` times
        its decrease constraint."""
        states = torch.atleast_2d(as_tensor(states))
        pol = self.policy if policy is None else as_deterministic(policy)
        if actions is not None:
            actions = torch.atleast_2d(as_tensor(actions))
        if lyapunov is None:
            return _future_values_core(pol, self.dynamics,
                                       self.reward_function,
                                       self.value_function, self.gamma,
                                       states, actions)
        return _future_values_lyapunov(
            pol, self.dynamics, self.reward_function, self.value_function,
            self.gamma, states, actions, lyapunov.lyapunov_function,
            lyapunov._lipschitz_lyapunov, lyapunov._lipschitz_dynamics,
            lyapunov.tau, lagrange_multiplier)

    def bellmann_error(self, states):
        """Squared Bellman error; the target is detached."""
        states = torch.atleast_2d(as_tensor(states))
        target = self.future_values(states).detach()
        residual = target - self.value_function(states).reshape(-1, 1)
        return (residual * residual).sum()

    def value_iteration(self):
        """One synchronous value-iteration sweep; updates the value
        function's parameters and returns them."""
        with torch.no_grad():
            new_values = self.future_values(self.state_space)
        self.value_function = self.value_function.with_parameters(
            {"parameters": new_values})
        return new_values

    def optimize_policy(self, steps=100, learning_rate=0.01,
                        batch_size=1000, generator=None, lyapunov=None,
                        lagrange_multiplier=1.0, sample_space=None):
        """Gradient ascent on the mean future value, ``steps`` SGD steps.

        Parameters
        ----------
        steps, batch_size : int
        learning_rate : float
        generator : torch.Generator on ``config.device``, optional
            Source of the uniform minibatches. Without one, an instance
            generator seeded 0 is carried across calls, so that repeated
            calls draw fresh minibatches.
        lyapunov : Lyapunov, optional
            Penalize the decrease condition's violation (Lagrangian).
        lagrange_multiplier : float
        sample_space : GridWorld, optional
            Domain of the minibatches (default: the value function's
            discretization).

        Returns
        -------
        losses : (steps,) numpy array of the negated mean future values,
            copied from the device once, at the end.
        """
        params = _require_parameters(self.policy)
        space = (sample_space if sample_space is not None
                 else self.value_function.discretization)
        if generator is None:
            if self._generator is None:
                self._generator = torch.Generator(
                    device=config.device).manual_seed(0)
            generator = self._generator
        limits = space.limits
        lo = as_tensor(limits[:, 0])
        hi = as_tensor(limits[:, 1])
        lyap = None
        if lyapunov is not None:
            lyap = (lyapunov.lyapunov_function,
                    lyapunov._lipschitz_lyapunov,
                    lyapunov._lipschitz_dynamics, lyapunov.tau,
                    float(lagrange_multiplier))
        draw = self._draw_minibatch
        params, losses = _policy_ascent(
            self.policy, params, self.dynamics, self.reward_function,
            self.value_function, self.gamma, lyap, float(learning_rate),
            lambda step: draw(generator, int(batch_size), lo, hi),
            steps=int(steps))
        self.policy = self.policy.with_parameters(params)
        return losses.cpu().numpy()

    # ------------------------------------------------------------------
    def _solve_inputs(self, policy):
        """``(vertices, weights, rewards)`` of the value solve under
        ``policy`` on the state grid."""
        actions = policy(self.state_space)
        next_states = self.dynamics(self.state_space, actions)
        if isinstance(next_states, (tuple, list)):
            next_states, _ = next_states
        rewards = self.reward_function(self.state_space,
                                       actions).reshape(-1, 1)
        vertices, weights = self.value_function.interpolation_weights(
            next_states)
        return vertices, weights, rewards

    def optimize_value_function(self, tol=None, max_iter=20000):
        """Exact PWL value solve: the fixed point of ``v = r + gamma B v``.

        ``tol`` is relative to ``max(1, max|v|)`` (default 1e-9 in
        float64, 1e-5 in float32). Raises ``OptimizationError`` when the
        solve does not reach it within ``max_iter`` iterations.
        """
        with torch.no_grad():
            vertices, weights, rewards = self._solve_inputs(self.policy)
            init = self.value_function.parameters[:, :1]
            if tol is None:
                tol = _default_tol(init.dtype)
            values, delta, iterations = _pwl_fixed_point(
                vertices, weights, rewards, self.gamma, init, tol,
                int(max_iter))
        delta, iterations = float(delta), int(iterations)
        self._last_solve = (iterations, delta)
        if not np.isfinite(delta) or delta > float(tol):
            raise OptimizationError(
                "PWL value iteration did not converge: delta={} after {} "
                "iterations".format(delta, iterations))
        self.value_function = self.value_function.with_parameters(
            {"parameters": values})
        return values

    # ------------------------------------------------------------------
    def policy_iteration(self, outer_iters=30, ascent_steps=200,
                         learning_rate=1.0, convergence_tol=0.1,
                         value_tol=None, value_max_iter=20000):
        """Full policy iteration.

        Alternates the exact PWL value solve with ``ascent_steps``
        gradient-ascent steps over the whole state grid on the one-step
        lookahead value, until both the value parameters and the policy's
        outputs over the grid change by at most ``convergence_tol``, or
        ``outer_iters`` iterations ran. The host waits for the device once
        per outer iteration, for that test.

        Requires a policy with trainable parameters and deterministic
        dynamics. Updates ``self.policy`` and ``self.value_function``.

        Returns
        -------
        info : dict
            ``iterations``, ``converged``, ``value_change``,
            ``policy_change``.

        Raises
        ------
        OptimizationError
            If any inner value solve failed to reach its tolerance (checked
            after the loop).
        """
        pparams = _tree_map(torch.Tensor.detach,
                            _require_parameters(self.policy))
        vparams = self.value_function.parameters[:, :1]
        if value_tol is None:
            value_tol = _default_tol(vparams.dtype)
        states, gamma, lr = self.state_space, self.gamma, float(learning_rate)
        inf = torch.full((), float("inf"), dtype=vparams.dtype,
                         device=vparams.device)
        value_change = policy_change = inf
        worst = torch.zeros((), dtype=vparams.dtype, device=vparams.device)
        iterations = 0
        while iterations < int(outer_iters):
            pol = self.policy.with_parameters(pparams)
            with torch.no_grad():
                vertices, weights, rewards = self._solve_inputs(pol)
                values, delta, _ = _pwl_fixed_point(
                    vertices, weights, rewards, gamma, vparams, value_tol,
                    int(value_max_iter))
            vf = self.value_function.with_parameters({"parameters": values})

            def loss(pp):
                return -1.0 / (1.0 - gamma) * torch.mean(_future_values_core(
                    self.policy.with_parameters(pp), self.dynamics,
                    self.reward_function, vf, gamma, states, None))

            new_pparams = pparams
            for _ in range(int(ascent_steps)):
                new_pparams, _ = _sgd_step(loss, new_pparams, lr)
            with torch.no_grad():
                value_change = (values - vparams).abs().max()
                policy_change = (self.policy.with_parameters(new_pparams)(
                    states) - pol(states)).abs().max()
                worst = torch.maximum(worst, delta)
            vparams, pparams = values, new_pparams
            iterations += 1
            if not bool((value_change > convergence_tol)
                        | (policy_change > convergence_tol)):
                break
        worst, vc, pc = (float(t) for t in (worst, value_change,
                                            policy_change))
        if not np.isfinite(worst) or worst > float(value_tol):
            raise OptimizationError(
                "PWL value iteration did not converge inside the policy "
                "iteration: worst delta={}".format(worst))
        self.value_function = self.value_function.with_parameters(
            {"parameters": vparams})
        self.policy = self.policy.with_parameters(pparams)
        tol = float(convergence_tol)
        return {"iterations": iterations,
                "converged": bool(vc <= tol and pc <= tol),
                "value_change": vc, "policy_change": pc}

    # ------------------------------------------------------------------
    def discrete_policy_optimization(self, action_space, constraint=None):
        """Exhaustive policy improvement over a discrete action set.

        The future values of every action at every state of the policy's
        discretization come from one batched call of ``n_options *
        n_states`` rows. ``constraint(actions)`` is called once per option
        with that option's ``(n_states, action_dim)`` actions; where it is
        negative the option is masked to ``-inf`` before the argmax.
        Updates the policy's parameters and returns the best actions.
        """
        with torch.no_grad():
            action_space = torch.atleast_2d(as_tensor(action_space))
            states = as_tensor(self.policy.discretization.all_points)
            n_states, n_options = states.shape[0], action_space.shape[0]
            actions = action_space.repeat_interleave(n_states, dim=0)
            values = self.future_values(states.repeat(n_options, 1),
                                        actions=actions)[:, 0].reshape(
                                            n_options, n_states)
            if constraint is not None:
                slack = torch.stack([
                    as_tensor(constraint(actions[i * n_states:
                                                 (i + 1) * n_states]))
                    .reshape(-1) for i in range(n_options)])
                values = torch.where(slack < 0, -torch.inf, values)
            best_actions = action_space[values.argmax(dim=0)]
        self.policy = self.policy.with_parameters(
            {"parameters": best_actions})
        return best_actions
