"""The decrease check, the refinement walk and the level cut, in plain
PyTorch.

A :class:`Model` holds one configuration's grid, policy, candidate,
Lipschitz terms, ``tau`` and GP dynamics at one :class:`~.gp.Precision`.
For a state ``x`` with action ``u = clip(-k x)`` and the GP's
``(mean, err)`` at ``(x, u)``, the decrease margin is

    m(x) = v(mean) - v(x) + sum_j L_v(mean)_j err_j + L_v(x) (1 + L_f) tau

and ``x`` passes when ``m(x) < 0``. A refined check evaluates every point
of the cell's ``R^d`` sub-grid at ``tau / R`` and passes when all do.
:func:`certify` runs the upstream sweep on those verdicts: the value-sorted
walk with refinement (``sweep = "sorted"``) or the whole-grid cut at the
smallest failing value (``"fused"``).
"""

from __future__ import annotations

import numpy as np
import torch

#: Refined sub-points a chunk of the walk evaluates (the upstream walk's
#: chunk; the result does not depend on it).
REFINED_POINTS_PER_CHUNK = 2 ** 20


def grid_points(limits, num_points):
    """The grid's vertices in row-major order, as float32 numbers held in
    float64: the states both sides evaluate."""
    axes = [np.linspace(lo, hi, n, dtype=np.float32)
            for (lo, hi), n in zip(limits, num_points)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.column_stack([c.ravel() for c in mesh]).astype(np.float64)


def unit_maxes(limits, num_points):
    lim = np.asarray(limits, np.float64)
    return (lim[:, 1] - lim[:, 0]) / (np.asarray(num_points) - 1)


class Model:
    """One certify instance at one precision.

    ``p`` the candidate's matrix, ``k`` the policy gain (``u = clip(-k x,
    lo, hi)``), ``lv`` either ``("local", M)`` (``L_v(x) = |M x|``,
    reduced by the 1-norm in the threshold) or ``("scalar", value)``,
    ``lf`` a number, ``tau``, ``gp`` a :class:`~.gp.GP` at ``prec``,
    ``refinement`` R and ``sweep`` ``"sorted"`` or ``"fused"``.
    """

    def __init__(self, limits, num_points, p, k, action_limits, lv, lf,
                 tau, gp, prec, refinement=1, sweep="fused"):
        self.prec = prec
        self.limits = np.asarray(limits, np.float64)
        self.num_points = tuple(int(n) for n in num_points)
        self.points = grid_points(limits, num_points)
        self.nindex = len(self.points)
        self.p = prec.tensor(p)
        self.k = prec.tensor(k)
        self.action_limits = tuple(float(a) for a in action_limits)
        self.lv_kind, lv_value = lv
        self.lv = (prec.tensor(lv_value) if self.lv_kind == "local"
                   else float(lv_value))
        self.lf = float(lf)
        self.tau = float(tau)
        self.gp = gp
        self.refinement = int(refinement)
        self.sweep = sweep
        r = self.refinement
        d = self.points.shape[1]
        combos = np.stack(np.meshgrid(*[np.arange(r)] * d, indexing="ij"),
                          axis=-1).reshape(-1, d).astype(np.float64)
        unit = -1.0 + 2.0 * combos / (r - 1.0) if r > 1 else 0 * combos
        self.offsets = prec.tensor(
            0.5 * (1.0 - 1.0 / r) * unit_maxes(limits, num_points) * unit)

    def states(self, index):
        """Grid states at flat ``index`` (numpy) as tensors."""
        return self.prec.tensor(self.points[np.asarray(index)])

    def values(self, x):
        return (self.prec.mm(x, self.p) * x).sum(dim=1)

    def policy(self, x):
        lo, hi = self.action_limits
        return torch.clamp(-self.prec.mm(x, self.k.T), lo, hi)

    def queries(self, x):
        """The GP's inputs ``(x, u)`` of the states ``x``."""
        return torch.cat([x, self.policy(x)], dim=1)

    def _lv(self, x):
        return (torch.abs(self.prec.mm(x, self.lv.T))
                if self.lv_kind == "local" else self.lv)

    def margin(self, x, tau):
        """The decrease margin ``m(x)`` at states ``x`` for ``tau``."""
        mean, err = self.gp.evaluate(self.queries(x))
        lv_next = self._lv(mean)
        bound = (lv_next * err).sum(dim=1)
        lv_x = self._lv(x)
        lv_term = lv_x.abs().sum(dim=1) if self.lv_kind == "local" else lv_x
        return (self.values(mean) - self.values(x) + bound
                + lv_term * (1.0 + self.lf) * tau)

    def block(self):
        return self.gp.block()

    def coarse(self, index):
        """``m(x)`` at the grid states ``index``, as float64 numpy."""
        index = np.asarray(index)
        out = np.empty(len(index))
        for lo in range(0, len(index), self.block()):
            part = index[lo:lo + self.block()]
            out[lo:lo + len(part)] = self.margin(
                self.states(part), self.tau).double().cpu().numpy()
        return out

    def refined(self, index):
        """The largest ``m`` over each state's ``R^d`` sub-grid at ``tau /
        R``, as float64 numpy: the state passes the refined check when it
        is below 0."""
        index = np.asarray(index)
        sub = self.offsets.shape[0]
        per = max(1, self.block() // sub)
        out = np.empty(len(index))
        for lo in range(0, len(index), per):
            part = index[lo:lo + per]
            x = self.states(part)
            flat = (x[:, None, :] + self.offsets[None]).reshape(-1, x.shape[1])
            m = self.margin(flat, self.tau / self.refinement)
            out[lo:lo + len(part)] = m.reshape(len(part), sub).max(
                dim=1).values.double().cpu().numpy()
        return out

    def grid_values(self):
        out = np.empty(self.nindex)
        for lo in range(0, self.nindex, 2 ** 20):
            idx = np.arange(lo, min(lo + 2 ** 20, self.nindex))
            out[lo:lo + len(idx)] = self.values(
                self.states(idx)).double().cpu().numpy()
        return out


def certify(model, initial, previous=None):
    """The upstream sweep on ``model``'s verdicts.

    ``initial`` is the initial set's mask; ``previous`` the safe set kept
    when the set may not shrink (``None``: it may). Returns ``(safe,
    c_max, levels)``: the certified mask, the level and each state's
    refinement (1 for a coarse pass or an exempt state, R for a refined
    rescue, 0 outside).
    """
    n = model.nindex
    exempt = np.array(initial, dtype=bool)
    if previous is not None:
        exempt |= previous
    values = model.grid_values()
    if model.sweep == "fused":
        passed = model.coarse(np.arange(n)) < 0
        failing = ~(passed | exempt)
        v_bad = values[failing].min() if failing.any() else np.inf
        safe = values < v_bad
        c_max = values[safe].max() if safe.any() else -np.inf
        levels = np.where(safe, 1, 0)
    else:
        order = np.argsort(values, kind="stable")
        passed = (model.coarse(order) < 0) | exempt[order]
        failing = np.nonzero(~passed)[0]
        r = model.refinement
        stop = n
        if len(failing) and r > 1:
            chunk = max(1, REFINED_POINTS_PER_CHUNK
                        // model.offsets.shape[0])
            for lo in range(0, len(failing), chunk):
                pos = failing[lo:lo + chunk]
                ok = model.refined(order[pos]) < 0
                if not ok.all():
                    stop = int(pos[np.argmin(ok)])
                    break
        elif len(failing):
            stop = int(failing[0])
        c_max = values[order[stop - 1]] if stop > 0 else -np.inf
        rank = np.arange(n)
        ref_sorted = np.where(passed, 1, np.where(rank < stop, r, 0))
        ref_sorted = np.where(rank < stop, ref_sorted, 0)
        safe = np.zeros(n, dtype=bool)
        safe[order] = rank < stop
        levels = np.zeros(n, dtype=int)
        levels[order] = ref_sorted
    if previous is not None:
        keep = previous & (levels == 0)
        safe |= previous
        levels[keep] = 1
    safe |= initial
    levels[initial] = np.maximum(levels[initial], 1)
    return safe, float(c_max), levels
