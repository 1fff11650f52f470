"""Stability verification of a fixed uncertain 1-D system, on the card.

Counterpart of ``examples/one_d_region_of_attraction_estimate.py:46-135``:
a GP prior over the closed-loop dynamics ``x+ = 0.25 x + g(x)`` with no
data, a posterior sample of it as the hidden true system, the
piecewise-linear Lyapunov candidate ``|x|``, and an active safe-learning
loop that measures the true system at the most uncertain safe state and
certifies again, until the certified region of attraction stops growing.
Every sweep and every evaluation of the GP runs the CUDA kernel of
composite-kernel GPs (``ops/gp_kernel.py::gp_predict_general_cuda``).
``--full`` runs the reference's sizes: 1001 states and 24 updates; the
quick mode 501 states and 20 updates.

Run:

    python -m safe_learning_tpu_torch.examples.one_d_region_of_attraction_estimate \
        [--full --plot]

``--extended`` and ``--hybrid`` (the rigor modes) are not ported yet.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from ..functions.base import as_tensor
from ..functions.gp import (ActiveDims, GaussianProcess, LinearKernel,
                            Matern32, sample_gp_function)
from ..functions.linear import LinearSystem
from ..functions.simplex import Triangulation
from ..grids import GridWorld
from ..lyapunov import Lyapunov
from ._common import Timer, example_args


def kernel():
    """The notebook's prior (cell 5): ``Matern32(0.4^2, 1)`` times
    ``Linear(1)``, both on the state column of ``(x, u)``."""
    return (ActiveDims(Matern32(variance=0.4 ** 2, lengthscales=1.0,
                                input_dim=1), dims=[0])
            * ActiveDims(LinearKernel(variances=1.0, input_dim=1), dims=[0]))


def run(full=False, seed=0, num_states=None, n_updates=None,
        extended=False):
    """The example's loop; ``num_states`` and ``n_updates`` override the
    sizes of ``full``.

    The true system is ``sample_gp_function`` of the data-free GP on 201
    points with the generator seeded ``seed``. Checks the example's
    assertion (the safe set grows beyond the initial ``|x| < 0.2``) and
    returns a namespace: the Lyapunov instance, the true system, the
    initial and per-update safe fractions, the measured states and the
    loop's wall time (``loop_s``).
    """
    if extended:
        raise NotImplementedError(
            "the extended and hybrid rigor modes are ROADMAP queue 1 items "
            "17 and 18")
    num_states = (1001 if full else 501) if num_states is None \
        else num_states
    n_updates = (24 if full else 20) if n_updates is None else n_updates

    discretization = GridWorld([[-1.0, 1.0]], num_states)
    tau = 1.0 / discretization.nindex
    print("Grid size:", discretization.nindex)

    mean_function = LinearSystem([[0.25, 0.0]])
    gp = GaussianProcess(kernel(), np.empty((0, 2)), np.empty((0, 1)),
                         noise_variance=0.01 ** 2, beta=2.0,
                         mean_function=mean_function,
                         capacity=max(32, n_updates))

    # One GP sample is the hidden true system (notebook cell 6).
    sample_disc = np.hstack([np.linspace(-1, 1, 201)[:, None],
                             np.zeros((201, 1))])
    generator = torch.Generator().manual_seed(seed)
    true_dynamics = sample_gp_function(sample_disc, gp, generator)[0]

    # The piecewise-linear candidate v(x) = |x| (notebook cell 7).
    lyapunov_function = Triangulation(GridWorld([[-1.0, 1.0]], 3),
                                      [1.0, 0.0, 1.0])
    policy = LinearSystem([[0.0]])
    lyap = Lyapunov(discretization, lyapunov_function, gp,
                    lipschitz_dynamics=0.25, lipschitz_lyapunov=1.0,
                    tau=tau, policy=policy)

    # Initial safe set: |x| < 0.2 (notebook cell 11).
    initial = np.abs(discretization.all_points.squeeze()) < 0.2
    lyap.initial_safe_set = initial
    lyap.safe_set |= initial
    lyap.update_safe_set()
    initial_fraction = float(lyap.safe_set.mean())
    print("initial safe fraction: {:.3f}".format(initial_fraction))

    # The whole grid's state-action pairs, on the device once.
    grid = as_tensor(discretization.all_points)
    xu_all = torch.cat([grid, lyap.policy(grid)], dim=1)
    measured = []

    def update_gp():
        """Measure the true system at the most uncertain safe state."""
        _, std = lyap.dynamics.evaluate(xu_all)
        safe = torch.as_tensor(np.asarray(lyap.safe_set), device=std.device)
        max_id = int(torch.argmax(torch.where(
            safe, std[:, 0], torch.full_like(std[:, 0], -np.inf))))
        arg = xu_all[max_id:max_id + 1]
        measurement = true_dynamics(arg).cpu().numpy()
        arg = arg.cpu().numpy()
        measured.append(arg[0])
        lyap.dynamics = lyap.dynamics.add_data_point(arg, measurement)
        lyap.update_safe_set()

    with Timer("active learning ({} updates)".format(n_updates)) as timer:
        fractions = []
        for _ in range(n_updates):
            update_gp()
            fractions.append(float(lyap.safe_set.mean()))

    print("safe fraction history:",
          " ".join("{:.3f}".format(f) for f in fractions))
    print("certified level c_max = {:.4f}".format(lyap.c_max))
    assert fractions[-1] > initial.mean(), \
        "safe set should grow beyond the initial set"
    return types.SimpleNamespace(
        lyap=lyap, true_dynamics=true_dynamics,
        initial_fraction=initial_fraction, fractions=fractions,
        measured=np.array(measured), loop_s=timer.seconds,
        n_updates=n_updates)


def main(argv=None):
    def _extra(parser):
        parser.add_argument("--extended", action="store_true",
                            help="double-word sweeps with the derived "
                                 "conservative margin (not ported)")
        parser.add_argument("--hybrid", action="store_true",
                            help="the hybrid band-filtered rigor mode (not "
                                 "ported)")

    args = example_args(__doc__, extra=_extra, argv=argv)
    if args.plot:
        raise NotImplementedError(
            "the example's plot needs plotting.plot_lyapunov_1d, ROADMAP "
            "queue 1 item 22")
    return run(full=args.full, seed=args.seed,
               extended=args.extended or args.hybrid)


if __name__ == "__main__":
    main()
