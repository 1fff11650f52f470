"""Learning a neural-network Lyapunov function (CoRL-18), on the card.

Counterpart of ``examples/lyapunov_function_learning.py:68-343``: a
positive-definite-by-construction ``LyapunovNetwork`` is pre-trained to
match a spherical quadratic on the initial set, saved and restored through
:mod:`~safe_learning_tpu_torch.checkpoints` (the notebook's
``tf.train.Saver``), then grown by ROA classification: states in the gap
between the certified level set and one 1.3 times larger are simulated
forward; those that fall back into the level set become positive labels
of a weighted perceptron loss with a decrease penalty. The learned safe
set is compared with the LQR quadratic's, an SOS candidate's and the true
ROA. Every certify is the fused sweep with the network's local Lipschitz
constant (``GradientNorm``). ``--full`` runs the reference's sizes: a
251^2 grid, 20 outer iterations of 10 classifier steps, 300 pre-training
steps and a 500-step ROA; the quick mode a 101^2 grid, 16 outer
iterations, 200 pre-training steps and a 300-step ROA.

Run:

    python -m safe_learning_tpu_torch.examples.lyapunov_function_learning \
        [--full]

``--extended`` and ``--hybrid`` (the rigor modes, ROADMAP item 18) and
``--plot`` (``plotting``, item 22) are not ported.
"""

from __future__ import annotations

import os
import tempfile
import types

import numpy as np
import torch

from .. import checkpoints
from ..analysis import compute_roa
from ..config import config
from ..dynamics import InvertedPendulum
from ..functions.base import GradientNorm, Saturation, as_tensor
from ..functions.linear import LinearSystem, QuadraticFunction
from ..functions.neural import LyapunovNetwork
from ..grids import GridWorld
from ..lyapunov import Lyapunov
from ..utils import derivative_monomials, dlqr, monomials
from ._common import Timer, _sgd, example_args, no_plot

# Degree-3 SOS Lyapunov candidate computed offline with SOSTOOLS for the
# LQR-stabilized pendulum (reference notebook cell 17).
_SOS_Q = np.array([
    [4.09, 0.09225, -5.609e-9, 2.132e-9, 6.079e-10, 2.11, 0.006847,
     0.0937, -0.0271],
    [0.09225, 0.2055, 2.132e-9, 6.079e-10, 1.731e-9, 0.006847, 0.0937,
     -0.0271, 0.03769],
    [-5.609e-9, 2.132e-9, 2.11, 0.006847, 0.0937, -6.223e-8, -1.307e-9,
     -3.692e-9, -5.893e-10],
    [2.132e-9, 6.079e-10, 0.006847, 0.0937, -0.0271, -1.307e-9,
     -3.692e-9, -5.893e-10, 4.724e-10],
    [6.079e-10, 1.731e-9, 0.0937, -0.0271, 0.03769, -3.692e-9,
     -5.893e-10, 4.724e-10, 2.836e-10],
    [2.11, 0.006847, -6.223e-8, -1.307e-9, -3.692e-9, 5.913, 0.2135,
     0.1824, 0.009201],
    [0.006847, 0.0937, -1.307e-9, -3.692e-9, -5.893e-10, 0.2135, 0.1824,
     0.009201, 0.01684],
    [0.0937, -0.0271, -3.692e-9, -5.893e-10, 4.724e-10, 0.1824,
     0.009201, 0.01684, 0.02061],
    [-0.0271, 0.03769, -5.893e-10, 4.724e-10, 2.836e-10, 0.009201,
     0.01684, 0.02061, 0.01081]])

#: The classifier's fixed target level (notebook cell 34) and the growth
#: of the training frontier beyond ``c_max``.
SAFE_LEVEL = 1.0
LEVEL_MULTIPLIER = 1.3


def sizes(full):
    """``(num_states, outer_iters, inner_iters, roa_horizon, gap_horizon,
    pretrain_iters)`` of a run."""
    if full:
        return 251, 20, 10, 500, 100, 300
    return 101, 16, 10, 300, 100, 200


def pendulum():
    """The full swing-up normalization of the notebook (cell 7)."""
    dt, g = 0.01, 9.81
    m, length, friction = 0.15, 0.5, 0.1
    theta_max, omega_max = np.deg2rad(180), np.deg2rad(360)
    u_max = g * m * length * np.sin(np.deg2rad(60))
    norms = ((theta_max, omega_max), (u_max,))
    return InvertedPendulum(m, length, friction, dt, normalization=norms)


def sos_safe_set(system, grid, policy):
    """The SOS baseline (notebook cell 17): the fixed degree-3 candidate in
    denormalized coordinates, certified by ``dv/dt < 0`` along the true
    vector field in value order. Returns its safe mask on the grid."""
    theta_max, omega_max = np.deg2rad(180), np.deg2rad(360)
    u_max = 9.81 * 0.15 * 0.5 * np.sin(np.deg2rad(60))
    x_denorm = grid.all_points * np.array([theta_max, omega_max])
    feats = monomials(x_denorm, 3).cpu().numpy().astype(np.float64)
    values = np.sum((feats @ _SOS_Q) * feats, axis=1)
    d_feats = derivative_monomials(x_denorm, 3).cpu().numpy()
    dvdx = 2.0 * np.einsum("nf,nfd->nd", feats @ _SOS_Q, d_feats)
    with torch.no_grad():
        u_denorm = policy(grid.all_points) * u_max
        f_cont = system.ode(as_tensor(x_denorm), u_denorm).cpu().numpy()
    dvdt = np.sum(dvdx * f_cont, axis=1)
    order = np.argsort(values)
    certificate = dvdt[order][1:] < 0
    ordered_idx = (len(certificate) + 1 if certificate.all()
                   else int(np.argmin(certificate)) + 1)
    return values <= values[order[ordered_idx - 1]]


def _pretrain(net, level_states, pretrain_iters, generator):
    """Match ``0.1 |x|^2`` on the initial set (notebook cells 25-26):
    ``pretrain_iters`` SGD steps at 0.1 on 1000 states drawn with
    replacement."""
    sphere = QuadraticFunction(0.1 * np.eye(2))
    params = net.parameters_dict
    n = level_states.shape[0]
    for _ in range(pretrain_iters):
        idx = torch.randint(0, n, (1000,), generator=generator,
                            device=level_states.device)
        states = level_states[idx]
        target = sphere(states)

        def loss(p):
            return torch.mean(torch.abs(net.with_parameters(p)(states)
                                        - target))

        params = _sgd(loss, params, 0.1, clip=False)
    return net.with_parameters(params)


def _classifier_steps(net, closed_loop, states_all, labels_all,
                      inner_iters, generator):
    """``inner_iters`` weighted-perceptron steps (notebook cells 30-35) on
    minibatches of 1000 states drawn with replacement, each class
    weighted by the batch size over its count; the decrease penalty is
    relative to the detached value, with weight 1000; SGD at 5e-3."""
    params = net.parameters_dict
    n = states_all.shape[0]
    for _ in range(inner_iters):
        idx = torch.randint(0, n, (1000,), generator=generator,
                            device=states_all.device)
        states, labels = states_all[idx], labels_all[idx]
        positive = labels > 0.5
        n_pos = torch.clamp(positive.sum(), min=1)
        n_neg = torch.clamp(positive.numel() - positive.sum(), min=1)
        weights = torch.where(positive, positive.numel() / n_pos,
                              positive.numel() / n_neg).to(labels.dtype)
        with torch.no_grad():
            future_states = closed_loop(states)

        def loss(p):
            nn = net.with_parameters(p)
            values = nn(states)
            future = nn(future_states)
            decision = SAFE_LEVEL - values
            classifier = weights * torch.relu(-(2.0 * labels - 1.0)
                                              * decision)
            decrease = labels * torch.relu(
                (future - values) / (values.detach() + 1e-8))
            return torch.mean(classifier + 1000.0 * decrease)

        params = _sgd(loss, params, 5e-3, clip=False)
    return net.with_parameters(params)


def run(full=False, seed=0, extended=False):
    """The example at the reference's sizes (``full``) or the quick ones.

    ``seed`` seeds the network's initialisation (``torch.Generator`` on the
    CPU) and, plus one, the minibatch draws on ``config.device``. Checks
    that the checkpoint round trip restores the pre-trained network bit
    for bit, and the example's assertions (the safe set grows; the
    network certifies more of the true ROA than the LQR quadratic).
    Returns a namespace: both Lyapunov instances, the true ROA, the SOS
    set, the safe fraction and ``c_max`` histories, each set's share of
    the true ROA, the checkpoint's path and the wall times.
    """
    if extended:
        raise NotImplementedError(
            "the extended and hybrid rigor modes are ROADMAP queue 1 item "
            "18")
    (num_states, outer_iters, inner_iters, roa_horizon, gap_horizon,
     pretrain_iters) = sizes(full)
    system = pendulum()
    a, b = system.linearize()
    grid = GridWorld([[-1.0, 1.0]] * 2, num_states)
    tau = 0.0  # zero-threshold mode (notebook cell 9)
    initial_safe_set = np.linalg.norm(grid.all_points, ord=2, axis=1) <= 0.1
    initial_idx = np.where(initial_safe_set)[0]
    print("Grid size: {}".format(grid.nindex))

    k, p_lqr = dlqr(a, b, np.eye(2), np.eye(1))
    policy = Saturation(LinearSystem(-k), -1.0, 1.0)
    l_pol = np.linalg.norm(-k, 1)
    l_dyn = float(np.linalg.norm(a, 1) + np.linalg.norm(b, 1) * l_pol)

    # LQR baseline certificate (notebook cell 15).
    quad = QuadraticFunction(p_lqr)
    lyap_lqr = Lyapunov(grid, quad, system, l_dyn, GradientNorm(quad, ord=1),
                        tau, policy, initial_set=initial_idx)
    lyap_lqr.update_safe_set()
    sos_safe = sos_safe_set(system, grid, policy)
    print("SOS baseline safe fraction: {:.3f}".format(sos_safe.mean()))

    def closed_loop(x):
        return system(x, policy(x))

    with Timer("compute true ROA ({} steps)".format(roa_horizon)) as t_roa:
        roa = compute_roa(grid, closed_loop, horizon=roa_horizon, tol=0.1)
    print("true ROA fraction: {:.3f}".format(roa.mean()))

    # Neural-network candidate (notebook cell 19), pre-trained.
    net = LyapunovNetwork(2, [64, 64, 64], ["tanh", "tanh", "tanh"],
                          eps=1e-8,
                          generator=torch.Generator().manual_seed(seed))
    generator = torch.Generator(device=config.device).manual_seed(seed + 1)
    points = as_tensor(grid.all_points)
    with Timer("pre-train NN candidate") as t_pre:
        net = _pretrain(net, points[as_tensor(initial_safe_set)],
                        pretrain_iters, generator)

    lyap_nn = Lyapunov(grid, net, system, l_dyn, GradientNorm(net, ord=1),
                       tau, policy, initial_set=initial_idx)
    lyap_nn.update_safe_set()
    print("pre-trained NN safe fraction: {:.3f} ({:.1f}% of ROA)".format(
        lyap_nn.safe_set.mean(), 100 * lyap_nn.safe_set.sum() / roa.sum()))

    # Snapshot the pre-trained parameters and restore them before training
    # (the notebook's tf.train.Saver, cells 29 and 32).
    ckpt_dir = tempfile.mkdtemp(prefix="lyap_ckpt_")
    ckpt_path = checkpoints.save_checkpoint(
        os.path.join(ckpt_dir, "pretrained"), net.parameters_dict)
    restored = net.with_parameters(checkpoints.restore_checkpoint(
        ckpt_path, net.parameters_dict))
    for w, r in zip(net.posdef_weights + net.extra_weights,
                    restored.posdef_weights + restored.extra_weights):
        assert (w is None and r is None) or torch.equal(w, r), \
            "the checkpoint must restore the network bit for bit"
    net = restored
    lyap_nn.lyapunov_function = net
    lyap_nn._lipschitz_lyapunov = GradientNorm(net, ord=1)
    lyap_nn.update_values()
    lyap_nn.update_safe_set()

    # ROA classification training (notebook cells 30-35): the classifier
    # targets the fixed level set {v < SAFE_LEVEL}.
    roa_estimate = np.array(lyap_nn.safe_set)
    c_history = [lyap_nn.c_max]
    frac_history = [float(lyap_nn.safe_set.mean())]
    with Timer("ROA classification ({} outer iters)".format(
            outer_iters)) as t_train:
        for _ in range(outer_iters):
            c = lyap_nn.c_max
            values = lyap_nn.values.reshape(-1).cpu().numpy()
            if not np.isfinite(c) or c <= 0.0:
                # Nothing beyond the exempt set certifies yet: grow the
                # frontier from the ROA estimate.
                c = float(np.max(values[roa_estimate]))
            idx_small = values <= c
            idx_big = values <= LEVEL_MULTIPLIER * c
            idx_gap = idx_big & ~idx_small

            # Forward-simulate the gap states.
            if idx_gap.any():
                gap = points[as_tensor(idx_gap)]
                with torch.no_grad():
                    for _ in range(gap_horizon):
                        gap = closed_loop(gap)
                    gap_values = net(gap).reshape(-1).cpu().numpy()
                roa_estimate[idx_gap] |= gap_values <= c

            target_idx = idx_big | roa_estimate
            states_all = points[as_tensor(target_idx)]
            labels_all = as_tensor(
                roa_estimate[target_idx].astype(np.float64).reshape(-1, 1))
            net = _classifier_steps(net, closed_loop, states_all,
                                    labels_all, inner_iters, generator)

            lyap_nn.lyapunov_function = net
            lyap_nn._lipschitz_lyapunov = GradientNorm(net, ord=1)
            lyap_nn.update_values()
            lyap_nn.update_safe_set()
            roa_estimate |= np.asarray(lyap_nn.safe_set)
            c_history.append(lyap_nn.c_max)
            frac_history.append(float(lyap_nn.safe_set.mean()))

    nn_vs_roa = float(lyap_nn.safe_set.sum() / roa.sum())
    lqr_vs_roa = float(lyap_lqr.safe_set.sum() / roa.sum())
    sos_vs_roa = float(sos_safe.sum() / roa.sum())
    print("safe-set fraction history:",
          " ".join("{:.3f}".format(f) for f in frac_history))
    print("final: NN {:.1f}%  vs  LQR {:.1f}%  vs  SOS {:.1f}% of ROA"
          .format(100 * nn_vs_roa, 100 * lqr_vs_roa, 100 * sos_vs_roa))
    assert frac_history[-1] > frac_history[0], \
        "NN safe set should grow during training"
    assert nn_vs_roa > lqr_vs_roa, \
        "learned candidate should certify more than the LQR baseline"
    return types.SimpleNamespace(
        lyap_nn=lyap_nn, lyap_lqr=lyap_lqr, roa=roa, sos_safe=sos_safe,
        frac_history=frac_history, c_history=c_history, nn_vs_roa=nn_vs_roa,
        lqr_vs_roa=lqr_vs_roa, sos_vs_roa=sos_vs_roa, ckpt_path=ckpt_path,
        roa_s=t_roa.seconds, pretrain_s=t_pre.seconds,
        train_s=t_train.seconds)


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
        no_plot("lyapunov_function_learning")
    return run(full=args.full, seed=args.seed,
               extended=args.extended or args.hybrid)


if __name__ == "__main__":
    main()
