"""Judge a certify's outputs against the float64 reference.

The program's outputs of one certify are its safe mask, ``c_max``, its
refinement levels and its grid values. They imply verdicts: a certified
state that is not exempt passed the coarse check (level 1) or failed it
and passed the refined one (level R); the state that ends the certified
prefix (the uncertified state of smallest value, the lowest index among
ties; for the fused sweep any one of its ties) failed both; a certified
state with another level claims the coarse pass. The reference works out
each implied verdict's margin ``m`` (``certify.Model``) and the values in
float64. The numbers, each the widest over the certify:

- ``verdict_gap``: how far the reference lies on the other side of a
  verdict the outputs imply, over ``v(stop)`` (the reference's value of
  the state that ends the prefix);
- ``cut_gap``: for a state whose membership disagrees with the cut at
  ``v(stop)`` by the reference's values, its distance from that value,
  over ``v(stop)``;
- ``cmax_gap``: ``|c_max - max v over the reference's prefix|``, over
  ``v(stop)``;
- ``posterior_gap``: the largest difference of the GP's mean or of its
  ``beta * std`` from the reference's, over all the sweep's queries, in
  normalised state units (from :func:`posterior_gap`).
"""

from __future__ import annotations

import numpy as np
import torch


def certify_gaps(model, outputs, initial, previous=None):
    """``{"verdict_gap", "cut_gap", "cmax_gap"}`` of one certify.

    ``model`` is the float64 reference :class:`~.certify.Model`;
    ``outputs`` holds the program's ``safe`` (bool), ``c_max``,
    ``levels`` (int) and ``values`` (the program's own grid values), as
    numpy; ``initial`` the initial set and ``previous`` the safe set the
    certify may not shrink (``None`` if it may).
    """
    safe = np.asarray(outputs["safe"], dtype=bool)
    levels = np.asarray(outputs["levels"])
    pvalues = np.asarray(outputs["values"], dtype=np.float64)
    exempt = np.array(initial, dtype=bool)
    if previous is not None:
        exempt |= previous
    r = model.refinement
    v64 = model.grid_values()
    outside = np.nonzero(~safe)[0]
    if len(outside):
        tie = outside[pvalues[outside] == pvalues[outside].min()]
        group = tie if model.sweep == "fused" else tie[:1]
        v_stop = float(v64[group].min())
    else:
        group = np.zeros(0, dtype=int)
        v_stop = float(v64.max())
    norm = abs(v_stop) if v_stop != 0 else 1.0

    gaps = [0.0]
    # A certified state that is not exempt and not a refined rescue
    # claims the coarse pass, whatever level the outputs give it.
    level1 = np.nonzero(safe & ~exempt & ((levels != r) if r > 1
                                          else True))[0]
    if len(level1):
        gaps.append(float(np.max(np.maximum(model.coarse(level1), 0.0))))
    rescued = np.nonzero(safe & ~exempt & (levels == r))[0] if r > 1 else []
    if len(rescued):
        gaps.append(float(np.max(np.maximum(-model.coarse(rescued), 0.0))))
        gaps.append(float(np.max(np.maximum(model.refined(rescued), 0.0))))
    if len(group):
        against = -model.coarse(group)
        if r > 1:
            against = np.maximum(against, -model.refined(group))
        # The claim is that (one of) the group fails: the gap is how far
        # the reference passes the state that comes closest to failing.
        gaps.append(float(np.maximum(np.min(against), 0.0)))
    verdict_gap = max(gaps) / norm

    below = v64 < v_stop
    if model.sweep == "sorted" and len(group):
        # The stable sort keeps the stop state's ties of lower index.
        below |= (v64 == v_stop) & (np.arange(len(v64)) < group[0])
    expected = exempt | below
    disagree = np.nonzero(safe != expected)[0]
    disagree = np.setdiff1d(disagree, group)
    cut_gap = (float(np.max(np.abs(v64[disagree] - v_stop))) / norm
               if len(disagree) else 0.0)

    prefix = below if len(group) else np.ones(len(v64), bool)
    c_ref = float(v64[prefix].max()) if prefix.any() else -np.inf
    c_max = float(outputs["c_max"])
    if np.isfinite(c_ref) and np.isfinite(c_max):
        cmax_gap = abs(c_max - c_ref) / norm
    else:
        cmax_gap = 0.0 if c_max == c_ref else float("inf")
    return dict(verdict_gap=verdict_gap, cut_gap=cut_gap, cmax_gap=cmax_gap)


def posterior_gap(model, evaluate):
    """The largest ``|mean - mean_ref|`` or ``|err - err_ref|`` over every
    grid state's query ``(x, clip(-k x))`` (made by the reference, rounded
    to float32 and handed to both), where ``evaluate(z)`` is the program's
    GP (``z`` a float32 numpy block, returning ``(mean, err)``)."""
    worst = 0.0
    block = max(4096, min(2 ** 20, model.block()))
    for lo in range(0, model.nindex, block):
        idx = np.arange(lo, min(lo + block, model.nindex))
        z64 = model.queries(model.states(idx)).cpu().numpy()
        z = z64.astype(np.float32)
        mean_ref, err_ref = model.gp.evaluate(
            model.prec.tensor(z.astype(np.float64)))
        mean, err = evaluate(z)
        d_mean = torch.as_tensor(mean, dtype=torch.float64).to(
            mean_ref.device) - mean_ref
        d_err = torch.as_tensor(err, dtype=torch.float64).to(
            err_ref.device) - err_ref
        worst = max(worst, float(d_mean.abs().max()),
                    float(d_err.abs().max()))
    return worst
