"""The one traffic generator: a cell's data, drawn from ``--seed``.

A workload file's ``inputs`` says where the GP's inputs lie: ``"box"``
draws every input, the action included, uniform in ``[-1, 1]``;
``"level_set"`` draws the state uniform in the candidate's level set ``v(x)
<= level`` (by rejection from the grid's box) and takes the policy's
action. Each input is rounded to float32 and measured with the
configuration's true system (``reference.dynamics``), and the measurement
is rounded to float32: both sides get these same numbers. The base data
are ``base_count`` rows (the configuration's zero datum first, where it
has one); then every request, warm-up ones first, gets one fresh row,
drawn in blocks of :data:`BLOCK` rows, each block from a stream of its
own. Each seed gives the same counts; only the rows differ.
"""

from __future__ import annotations

import numpy as np


def rng_of(seed, *stream):
    """A generator for ``stream`` (small ints) of ``seed`` (any int)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, *stream]))


def draw_inputs(rng, number, inputs, design, limits):
    """``number`` GP inputs ``(x, u)`` as float32 numbers in float64."""
    k = np.asarray(design["k"])
    n_u, n_x = k.shape
    if inputs["kind"] == "box":
        z = rng.uniform(-1.0, 1.0, size=(number, n_x + n_u))
        return z.astype(np.float32).astype(np.float64)
    if inputs["kind"] != "level_set":
        raise ValueError("unknown inputs kind " + inputs["kind"])
    p = np.asarray(design["p"])
    lim = np.asarray(limits, np.float64)
    rows = []
    while sum(len(r) for r in rows) < number:
        x = rng.uniform(lim[:, 0], lim[:, 1], size=(4 * number, n_x))
        x = x.astype(np.float32).astype(np.float64)
        rows.append(x[np.einsum("ij,jk,ik->i", x, p, x)
                      <= inputs["level"]])
    x = np.concatenate(rows)[:number]
    u = np.clip(-x @ k.T, *inputs.get("action_limits", (-1.0, 1.0)))
    return np.hstack([x, u.astype(np.float32).astype(np.float64)])


def measure(system, z):
    """The true system's next states at the inputs ``z``, float32 in
    float64."""
    n_x = system.state_dim
    y = system(z[:, :n_x], z[:, n_x:])
    return y.astype(np.float32).astype(np.float64)


#: Request rows a block draws from its own stream: row ``i`` is the
#: ``i % BLOCK``-th of block ``i // BLOCK`` whatever rows were asked
#: for before, so a seed gives the same rows at any ``--seconds``.
BLOCK = 64


class Traffic:
    """A cell's data for one seed: ``base_x``, ``base_y`` and the
    requests' rows ``pair(i)`` (``i`` from 0, warm-up requests first)."""

    def __init__(self, cfg, workload, reference, seed):
        self.cfg, self.workload, self.seed = cfg, workload, seed
        self.system = reference.true_system(cfg)
        self.design = reference.design(cfg)
        self.limits = cfg["grid_limits"]
        self.inputs = dict(workload["inputs"])
        self.inputs.setdefault("action_limits", cfg["action_limits"])
        drawn = workload["base_count"]
        zero = cfg.get("gp_zero_datum", False)
        n_in = np.asarray(self.design["k"]).shape[1] + 1
        z = draw_inputs(rng_of(seed, 0), drawn - int(zero), self.inputs,
                        self.design, self.limits)
        y = measure(self.system, z)
        if zero:
            z = np.vstack([np.zeros((1, n_in)), z])
            y = np.vstack([np.zeros((1, y.shape[1])), y])
        self.base_x, self.base_y = z, y
        self._blocks = {}

    def _block(self, b):
        if b not in self._blocks:
            z = draw_inputs(rng_of(self.seed, 1, b), BLOCK, self.inputs, self.design,
                            self.limits)
            self._blocks[b] = z, measure(self.system, z)
        return self._blocks[b]

    def prepare(self, number):
        """Draw the rows of the first ``number`` requests now (set-up), so
        that no request waits for the generator."""
        for b in range(-(-int(number) // BLOCK)):
            self._block(b)

    def pair(self, i):
        """Request ``i``'s row ``(x (1, n), y (1, p))``, float64 holding
        float32 numbers."""
        z, y = self._block(i // BLOCK)
        j = i % BLOCK
        return z[j:j + 1], y[j:j + 1]
