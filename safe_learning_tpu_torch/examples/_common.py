"""Shared scaffolding of the example scripts.

Counterpart of ``examples/_common.py``: the command line every script
takes (``--full`` for the reference's sizes, ``--plot`` to save figures,
``--seed``), a wall-clock ``Timer`` and the joint actor-critic training of
the reinforcement-learning examples (``make_actor_critic``).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..config import config
from ..utils import _tree_leaves, _tree_map


def example_args(description, extra=None, argv=None):
    """Parse the standard example command line (``--full``, ``--plot``,
    ``--seed N``); ``extra(parser)`` adds a script's own options."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--full", action="store_true",
                        help="the reference's sizes (slow on a CPU)")
    parser.add_argument("--plot", action="store_true",
                        help="save figures as PNG")
    parser.add_argument("--seed", type=int, default=0)
    if extra is not None:
        extra(parser)
    return parser.parse_args(argv)


def save_plot(name):
    """Save the current matplotlib figure as ``name.png`` beside the
    scripts."""
    import matplotlib.pyplot as plt

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       name + ".png")
    plt.gcf().savefig(out, dpi=120, bbox_inches="tight")
    plt.close("all")
    print("saved", out)


class Timer:
    """Context manager that prints a labelled wall-clock duration and keeps
    it in ``seconds``. On a CUDA device it waits for the device at both
    ends, so the time covers the device's work."""

    def __init__(self, label):
        self.label = label
        self.seconds = None

    @staticmethod
    def _wait():
        if config.device.type == "cuda":
            torch.cuda.synchronize(config.device)

    def __enter__(self):
        self._wait()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._wait()
        self.seconds = time.perf_counter() - self.start
        print("{}: {:.2f}s".format(self.label, self.seconds))


def _uniform_states(generator, batch, state_dim):
    """One minibatch of ``batch`` states uniform in ``[-1, 1]^state_dim``,
    drawn from ``generator`` in the working dtype on ``config.device``.
    The harness's only source of random numbers."""
    u = torch.rand((batch, state_dim), generator=generator,
                   dtype=config.dtype, device=config.device)
    return 2.0 * u - 1.0


def _clip(grads, max_norm=1.0):
    """Scale a list of gradients to a global norm of at most
    ``max_norm``."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [g * scale for g in grads]


def _sgd(loss_fn, params, learning_rate):
    """One plain SGD step on a parameter tree with the gradient clipped to
    a global norm of 1; returns detached parameters."""
    leaves = _tree_map(lambda w: w.detach().requires_grad_(True), params)
    flat = _tree_leaves(leaves)
    with torch.enable_grad():
        grads = torch.autograd.grad(loss_fn(leaves), flat)
    step = dict(zip(map(id, flat), _clip(list(grads))))
    with torch.no_grad():
        return _tree_map(lambda w: w - learning_rate * step[id(w)], leaves)


def make_actor_critic(policy, value_function, dynamics, reward_function,
                      gamma, r_max, state_dim, value_iters, policy_iters,
                      joint_iters, batch=100, value_lr=0.005, policy_lr=4.0):
    """Joint actor-critic training of the reinforcement-learning examples.

    Counterpart of ``examples/_common.py:71-148``. Returns
    ``train(pol_params, vf_params, generator) -> (pol_params, vf_params)``,
    which runs ``joint_iters`` times ``value_iters`` temporal-difference
    steps on the value function and ``policy_iters`` ascent steps on the
    policy, each on a fresh minibatch of ``batch`` states uniform in
    ``[-1, 1]^state_dim`` (``_uniform_states``), each gradient clipped to a
    global norm of 1, plain SGD at ``value_lr`` and ``policy_lr``:

    - the value step minimizes ``mean |v(x) - (r + gamma v(f(x, pi(x))))|
      / r_max`` with the target held fixed;
    - the policy step maximizes ``(1 - gamma) / r_max * mean(r + gamma
      v(f(x, pi(x))))``.

    The parameters are ``parameters_dict`` trees; the steps are eager and
    make the host wait nowhere.
    """
    def value_step(vf, pol, states):
        with torch.no_grad():
            actions = policy.with_parameters(pol)(states)
            rewards = reward_function(states, actions)
            future = dynamics(states, actions)
            target = rewards + gamma * value_function.with_parameters(vf)(
                future)

        def loss(p):
            v = value_function.with_parameters(p)
            return torch.mean(torch.abs(v(states) - target)) / r_max

        return _sgd(loss, vf, value_lr)

    def policy_step(pol, vf, states):
        v = value_function.with_parameters(vf)

        def loss(p):
            actions = policy.with_parameters(p)(states)
            rewards = reward_function(states, actions)
            future = dynamics(states, actions)
            return -(1 - gamma) / r_max * torch.mean(rewards
                                                     + gamma * v(future))

        return _sgd(loss, pol, policy_lr)

    def train(pol, vf, generator):
        for _ in range(joint_iters):
            for _ in range(value_iters):
                vf = value_step(
                    vf, pol, _uniform_states(generator, batch, state_dim))
            for _ in range(policy_iters):
                pol = policy_step(
                    pol, vf, _uniform_states(generator, batch, state_dim))
        return pol, vf

    return train
