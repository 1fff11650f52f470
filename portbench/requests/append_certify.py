"""One measurement appended, then a certify: what the safe-learning loop
does after each measurement.

Set-up builds the configuration's instance through the port's public API
on the base data, certifies once from the initial set (that certify is
checked too) and keeps its safe set. Each request restores that safe set
through ``Lyapunov.safe_set`` (before its clock starts), appends its one
fresh row (``add_data_point`` on the base GP, which it leaves as it was),
sets the new GP as the dynamics and runs ``update_safe_set`` with the
configuration's arguments. It ends when the safe mask and ``c_max`` are on
the host, as ``update_safe_set`` leaves them. So every request does the
same kind of work, and none inherits another's result.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import judge
from ..reference.certify import grid_points
from ..reference.gp import Precision


class Request:
    """The request kind of one cell at one seed: ``setup()``,
    ``restore()``, ``run(i, span)``, and ``check(kept, device)`` after the
    window."""

    def __init__(self, cell, traffic, program, reference, seed):
        self.cell = cell
        self.cfg = cell.config
        self.traffic = traffic
        self.program = program
        self.reference = reference
        self.seed = seed
        self.can_shrink = bool(self.cfg["can_shrink"])
        self.kwargs = dict(can_shrink=self.can_shrink,
                           max_refinement=self.cfg["max_refinement"])
        if "safety_factor" in self.cfg:
            self.kwargs["safety_factor"] = self.cfg["safety_factor"]

    def setup(self):
        """Build, certify from the initial set, keep that certify's
        outputs for the check and its safe set for every request."""
        points = grid_points(self.cfg["grid_limits"],
                             [self.cfg["grid_points"]]
                             * len(self.cfg["grid_limits"]))
        self.nindex = len(points)
        self.initial = self.reference.initial_set(self.cfg, points)
        self.lyap = self.program.build(
            self.cfg, self.traffic.base_x.astype(np.float32),
            self.traffic.base_y.astype(np.float32), self.initial)
        self.base_gp = self.lyap.dynamics
        before = np.array(self.lyap.safe_set)
        self.lyap.update_safe_set(**self.kwargs)
        self.setup_outputs = self.outputs(
            None, self.base_gp, None if self.can_shrink else before)
        self.start_set = np.array(self.lyap.safe_set)

    def restore(self):
        self.lyap.safe_set = self.start_set.copy()

    def run(self, i, span):
        """Request ``i``: ``(append seconds, outputs)``; ``span(name)`` is
        a context manager around each layer's call."""
        x, y = self.traffic.pair(i)
        t0 = time.perf_counter()
        with span("portbench.append"):
            gp = self.base_gp.add_data_point(x.astype(np.float32),
                                             y.astype(np.float32))
        t1 = time.perf_counter()
        with span("portbench.certify"):
            self.lyap.dynamics = gp
            self.lyap.update_safe_set(**self.kwargs)
        return t1 - t0, self.outputs(
            i, gp, None if self.can_shrink else self.start_set)

    def outputs(self, i, gp, previous):
        """What a certify produced, held by reference (nothing copied):
        the safe mask, ``c_max``, the refinement levels, the grid values
        and the GP, with the request's index and the set it kept."""
        lyap = self.lyap
        return dict(index=i, safe=lyap.safe_set, c_max=lyap.c_max,
                    levels=lyap._refinement, values=lyap.values, gp=gp,
                    previous=previous)

    def data(self, index):
        """The GP's data of request ``index`` (``None``: set-up's)."""
        x, y = self.traffic.base_x, self.traffic.base_y
        if index is None:
            return x, y
        px, py = self.traffic.pair(index)
        return np.vstack([x, px]), np.vstack([y, py])

    def release(self):
        """Drop the program's state but the kept outputs."""
        self.lyap = self.base_gp = None

    def check(self, kept, device):
        """The numbers of ``reference.judge`` over set-up's certify and
        the ``kept`` requests' (each the widest over them)."""
        prec = Precision("float64", device)
        numbers = dict(verdict_gap=0.0, cut_gap=0.0, cmax_gap=0.0,
                       posterior_gap=0.0)
        for out in [self.setup_outputs] + list(kept):
            x, y = self.data(out["index"])
            model = self.reference.model(self.cfg, x, y, prec)
            outputs = dict(out)
            outputs["safe"] = np.asarray(out["safe"])
            outputs["values"] = out["values"].double().cpu().numpy()
            previous = out["previous"]
            gaps = judge.certify_gaps(model, outputs, self.initial,
                                      previous)
            gp = out["gp"]

            def evaluate(z, gp=gp):
                with torch.no_grad():
                    mean, err = gp.evaluate(torch.as_tensor(
                        z, device=gp.X_buf.device))
                return mean, err

            gaps["posterior_gap"] = judge.posterior_gap(model, evaluate)
            for key, value in gaps.items():
                numbers[key] = max(numbers[key], value)
        return numbers
