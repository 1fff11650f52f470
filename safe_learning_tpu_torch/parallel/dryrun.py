"""Multi-process dryrun: N ranks over ``torch.distributed``, one device each.

Counterpart of ``scripts/multiprocess_dryrun.py``, on the same instances
and in the same five phases, each rank sharding its work over a global
mesh (``parallel.distributed``):

1. the fused sweep (``sharded_certified_level``);
2. the adaptive refinement (the sorted sweep's coarse batch and
   refinement chunks split over the ranks, the verdicts gathered), then a
   fused ``can_shrink=False`` pass over the refined state;
3. one exploration round: ``get_safe_sample_batch`` on the coordinator
   (``rng=np.random.default_rng(0)``), its pairs and measurements sent to
   every rank (``broadcast_from_coordinator``), the GP append and a
   re-verification;
4. the extended and hybrid sweeps, which must be equal;
5. one training step over a 2-D ``(data, model)`` layout of the ranks:
   each data rank takes its slice of the 16 states, each model rank holds
   a row block of the ``Triangulation`` table; a lookup sums the local
   rows' contributions over the model group (an autograd function whose
   backward passes the gradient through), and the gradients and the loss
   are summed over the data group, the loss weighted as the full batch's
   mean.

Phases 1-4 must agree bit for bit with a single-process run of the same
sequence (made by the launcher while the ranks run); phase 5's loss and
updates within ``TRAIN_RTOL`` of their own scale (:func:`step_departure`;
the sums over ranks change the order of the additions).

Launcher mode (default) starts ``--nprocs`` workers of this module on a
free local port, each with a time limit, and prints their results and a
last line ``multiprocess dryrun OK ...``. Worker mode (``--worker``) joins
the group and prints its JSON result::

    python -m safe_learning_tpu_torch.parallel.dryrun --nprocs 2 \\
        [--device cuda:0] [--backend gloo|nccl]

Several ranks on one card need gloo (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["build_instance", "build_gp_instance", "training_instance",
           "train_step", "step_departure", "program_tuples", "run_phases",
           "main"]

#: The largest departure (:func:`step_departure`) a rank's training step
#: may take from the single-process step. The ranks' sums add in another
#: order, which moves a float32 update in its last bits; a fault of the
#: sums (a model or data gradient counted twice, a data rank's states left
#: out) moves it by a tenth or more.
TRAIN_RTOL = 1e-5

#: Seconds a worker may take (start-up included).
WORKER_TIMEOUT_S = 600


def build_instance():
    """The linear instance of phase 1 (``multiprocess_dryrun.py:47-66``)."""
    import safe_learning_tpu_torch as st

    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 32)
    a = np.array([[0.6, 0.1], [0.0, 0.5]])
    dyn = st.LinearSystem([a, np.zeros((2, 1))])
    policy = st.LinearSystem(np.zeros((1, 2)))
    v = st.QuadraticFunction(np.eye(2))
    lf = float(np.linalg.norm(a, 2))
    vals = np.sum(grid.all_points ** 2, axis=1)
    initial = np.where(vals <= np.quantile(vals, 0.05))[0]
    return st.Lyapunov(grid, v, dyn, lf, 2.0, 0.05, policy,
                       initial_set=initial)


def build_gp_instance(adaptive=False):
    """The stacked-GP instance of phases 2-4 (``multiprocess_dryrun.py:
    69-105``): contracting mean dynamics and GP uncertainty growing away
    from 24 measurements near the origin. Returns ``(lyapunov,
    true_dynamics)``."""
    import safe_learning_tpu_torch as st

    rng = np.random.default_rng(7)
    grid = st.GridWorld([[-1.0, 1.0], [-1.0, 1.0]], 32)
    av = np.array([[0.25, 0.05], [0.0, 0.3]])
    policy = st.LinearSystem(np.zeros((1, 2)))
    v = st.QuadraticFunction(np.eye(2))
    lv = st.LambdaFunction(lambda x: 2.0 * torch.abs(x))
    lf = float(np.linalg.norm(av, 2))
    x_inner = np.column_stack([
        rng.uniform(-0.4, 0.4, 24), rng.uniform(-0.4, 0.4, 24),
        np.zeros(24)])
    gp = st.StackedGaussianProcess(
        [st.RBF(1.0, [0.3] * 3, input_dim=3),
         st.RBF(1.0, [0.35] * 3, input_dim=3)], x_inner,
        x_inner[:, :2] @ av.T, noise_variances=1e-4,
        mean_functions=[st.LinearSystem([av[[d]], np.zeros((1, 1))])
                        for d in range(2)], capacity=64)
    tau = float(np.min(grid.unit_maxes))
    vals = np.sum(grid.all_points ** 2, axis=1)
    initial = np.where(vals <= 0.02)[0]
    lyap = st.Lyapunov(grid, v, gp, lf, lv, tau, policy,
                       initial_set=initial, adaptive=adaptive)
    return lyap, st.LinearSystem([av, np.zeros((2, 1))])


def program_tuples():
    """The covariance-program tuples the dryrun's GPs launch (kernel 3's
    libraries), so that a caller can build them beforehand."""
    lyap, _ = build_gp_instance()
    return [lyap.dynamics._programs()[0]]


def _hash(arr):
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def training_instance(net=None):
    """Phase 5's pieces (``multiprocess_dryrun.py:226-247``): the 8x16
    grid, the LQR policy of the linearized pendulum, a GP on 16 pendulum
    transitions, a ``[4, 4]`` tanh ``LyapunovNetwork`` (``net``, or one
    from the port's seeded initialisation), the zero ``Triangulation``
    value table and the grid's first 16 states."""
    import safe_learning_tpu_torch as st
    from safe_learning_tpu_torch.functions.base import as_tensor
    from safe_learning_tpu_torch.utils import dlqr

    grid = st.GridWorld([[-0.5, 0.5], [-1.0, 1.0]], [8, 16])
    pend = st.InvertedPendulum(mass=0.25, length=0.5, friction=0.1,
                               dt=0.01)
    a, b = pend.linearize()
    kmat, _ = dlqr(a, b, np.eye(2), np.eye(1))
    rng = np.random.default_rng(0)
    x_train = np.column_stack([
        rng.uniform(-0.5, 0.5, 16), rng.uniform(-1.0, 1.0, 16),
        rng.uniform(-0.8, 0.8, 16)])
    with torch.no_grad():
        y_train = pend(as_tensor(x_train[:, :2]),
                       as_tensor(x_train[:, 2:])).cpu().numpy()
    gp = st.GaussianProcess(
        st.RBF(0.01, [0.3, 0.3, 0.5], input_dim=3), x_train, y_train,
        noise_variance=1e-6, mean_function=st.LinearSystem([a, b]))
    if net is None:
        net = st.LyapunovNetwork(2, [4, 4], ["tanh", "tanh"])
    return dict(grid=grid, policy=st.LinearSystem(-kmat), gp=gp, net=net,
                value_fn=st.Triangulation(grid, np.zeros(grid.nindex),
                                          project=True),
                states=as_tensor(grid.all_points[:16]))


class _ModelSum(torch.autograd.Function):
    """Sum of each model rank's partial lookup over the model group. Every
    rank goes on with the same sum, so the gradient of its partial is the
    sum's gradient as it is (the backward passes it through)."""

    @staticmethod
    def forward(ctx, partial, group):
        from .distributed import reduce_tensor

        return reduce_tensor(partial, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def train_step(inst, data=(0, 1), model=(0, 1), groups=(None, None),
               gamma=0.98, lr=1e-3):
    """One SGD step of ``multiprocess_dryrun.py:248-271``'s loss.

    ``data = (index, size)`` and ``model = (index, size)`` place this rank
    in the ``(data, model)`` layout; ``groups`` are its ``(data group,
    model group)`` (``None`` for a size of 1). Returns ``(loss, network
    update, table update)``, the same on every rank: the loss before the
    step, and the step's ``-lr * gradient`` of the network parameters
    (flattened in ``parameters_dict``'s sorted order) and of the table
    (gathered over the model group). The parameters after the step are
    the old ones plus the update.
    """
    from .mesh import split_rows

    (d_idx, d_size), (m_idx, m_size) = data, model
    data_group, model_group = groups
    value_fn, net, gp, policy = (inst["value_fn"], inst["net"], inst["gp"],
                                 inst["policy"])
    nindex = value_fn.parameters.shape[0]
    rows = split_rows(nindex, m_size)
    lo, hi = rows[m_idx]
    table = value_fn.parameters[lo:hi].detach().clone().requires_grad_(True)
    params = {name: tuple(None if p is None
                          else p.detach().clone().requires_grad_(True)
                          for p in leaves)
              for name, leaves in net.parameters_dict.items()}
    model_net = net.with_parameters(params)
    n_total = inst["states"].shape[0]
    s_lo, s_hi = split_rows(n_total, d_size)[d_idx]
    states = inst["states"][s_lo:s_hi]

    def lookup(x):
        vertices, weights = value_fn.interpolation_weights(x)
        local = (vertices >= lo) & (vertices < hi)
        vals = table[(vertices - lo).clamp(0, hi - lo - 1)][..., 0]
        partial = (weights * torch.where(local, vals,
                                         torch.zeros_like(vals))).sum(dim=1)
        if model_group is None:
            return partial
        return _ModelSum.apply(partial, model_group)

    actions = policy(states)
    with torch.no_grad():
        mean, err = gp(states, actions)
    decrease = (model_net(mean).reshape(-1) - model_net(states).reshape(-1)
                + err.sum(dim=1))
    lyap_loss = torch.relu(decrease + 1e-3).sum() / n_total
    reward = -(states[:, 0] ** 2 + 0.1 * actions[:, 0] ** 2)
    target = reward + gamma * lookup(mean)
    bellman = ((lookup(states) - target.detach()) ** 2).sum() / n_total
    loss = lyap_loss + bellman
    leaves = [p for name in sorted(params) for p in params[name]
              if p is not None]
    grads = torch.autograd.grad(loss, leaves + [table])
    if data_group is not None:
        from .distributed import reduce_tensor

        grads = [reduce_tensor(g, "sum", data_group) for g in grads]
        loss = reduce_tensor(loss, "sum", data_group)
    net_update = torch.cat([-lr * g.reshape(-1) for g in grads[:-1]])
    table_update = -lr * grads[-1]
    if model_group is not None:
        table_update = _gather_model_rows(table_update, rows, m_idx, d_idx,
                                          m_size, model_group)
    return float(loss.detach()), net_update, table_update


def _gather_model_rows(block, rows, m_idx, d_idx, m_size, group):
    """The whole table from each model rank's row block (each block
    broadcast by its owner within the model group)."""
    import torch.distributed as dist

    from .distributed import _comm_device

    whole = torch.empty((rows[-1][1],) + tuple(block.shape[1:]),
                        dtype=block.dtype, device=_comm_device())
    for m, (lo, hi) in enumerate(rows):
        if hi <= lo:
            continue
        view = whole[lo:hi]
        if m == m_idx:
            view.copy_(block)
        dist.broadcast(view, src=d_idx * m_size + m, group=group)
    return whole.to(block.device)


def _launches():
    from ..ops import gp_kernel

    return {name: wrapper.launches
            for name, (wrapper, _, _) in gp_kernel.kernels().items()}


def run_phases(mesh=None, layout=None):
    """Run the five phases; return the result dict.

    ``mesh=None`` is the single-process reference; otherwise the global
    grid mesh, and ``layout`` this rank's ``(data, model, groups)`` for
    :func:`train_step`. Each phase's wall seconds and kernel launches are
    under ``"seconds"`` and ``"launches"``.
    """
    import safe_learning_tpu_torch as st
    from safe_learning_tpu_torch.ops.extended_verify import (
        extended_certificate_margin)

    from .distributed import (broadcast_from_coordinator, is_coordinator,
                              sharded_certified_level)

    out, seconds, launches = {}, {}, {}

    def timed(name, fn):
        before = _launches()
        start = time.perf_counter()
        fn()
        if st.config.device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - start
        launches[name] = {k: v - before[k] for k, v in _launches().items()
                          if v - before[k]}

    def fused():
        lyap = build_instance()
        if mesh is None:
            lyap.update_safe_set()
            safe, c_max = np.asarray(lyap.safe_set), float(lyap.c_max)
        else:
            safe, c_max = sharded_certified_level(lyap, mesh)
        out["fused"] = {"safe_sum": int(np.sum(safe)), "safe_hash":
                        _hash(np.asarray(safe)), "c_max": float(c_max),
                        "ref_hash": _hash(lyap._refinement),
                        "values_hash": _hash(lyap.values)}

    def adaptive():
        lyap, _ = build_gp_instance(adaptive=True)
        lyap.mesh = mesh
        lyap.update_safe_set(max_refinement=2)
        res = {"safe_sum": int(np.sum(lyap.safe_set)),
               "safe_hash": _hash(np.asarray(lyap.safe_set)),
               "c_max": float(lyap.c_max),
               "ref_hash": _hash(lyap._refinement)}
        # A fused can_shrink=False pass over the refined state: kept but
        # not re-certified states keep their refinement level.
        lyap.update_safe_set(can_shrink=False)
        res["ref_hash_kept"] = _hash(lyap._refinement)
        res["safe_hash_kept"] = _hash(np.asarray(lyap.safe_set))
        out["adaptive"] = res

    def explore():
        lyap, true_dyn = build_gp_instance()
        lyap.mesh = mesh
        lyap.update_safe_set()
        k = 3
        perturbations = np.linspace(-0.1, 0.1, 5)[:, None]
        if mesh is None or is_coordinator():
            xu, y, _, flags = st.get_safe_sample_batch(
                lyap, true_dyn, k, perturbations, num_samples=32,
                rng=np.random.default_rng(0), apply=False)
            if not flags.all():
                raise AssertionError("exploration must take its primary "
                                     "branch")
            xu, y = np.asarray(xu), np.asarray(y)
        else:
            xu = y = None
        if mesh is not None:
            xu, y = broadcast_from_coordinator((xu, y))
        lyap.dynamics = lyap.dynamics.add_data_point(xu, y)
        lyap.update_safe_set(can_shrink=False)
        gp = lyap.dynamics
        out["explore"] = {
            "count": int(gp.count), "xu_hash": _hash(xu),
            "y_hash": _hash(y), "xbuf_hash": _hash(gp.X_buf),
            "safe_hash": _hash(np.asarray(lyap.safe_set)),
            "ref_hash": _hash(lyap._refinement), "c_max": float(lyap.c_max)}

    def extended():
        lyap, _ = build_gp_instance()
        lyap.mesh = mesh
        lyap.extended_lv_matrix = 2.0 * np.eye(2)
        extended_certificate_margin(lyap, lv_matrix=lyap.extended_lv_matrix)
        lyap.update_safe_set(extended=True)
        res = {"safe_sum": int(np.sum(lyap.safe_set)),
               "safe_hash": _hash(np.asarray(lyap.safe_set)),
               "c_max": float(lyap.c_max)}
        lyap.safe_set = np.zeros(lyap.discretization.nindex, dtype=bool)
        lyap.safe_set |= lyap.initial_safe_set
        lyap.update_safe_set(extended="hybrid")
        res["hybrid_safe_hash"] = _hash(np.asarray(lyap.safe_set))
        res["hybrid_c_max"] = float(lyap.c_max)
        res["band_fraction"] = float(lyap.last_band_fraction)
        if (res["hybrid_safe_hash"], res["hybrid_c_max"]) != (
                res["safe_hash"], res["c_max"]):
            raise AssertionError("hybrid must equal extended")
        out["extended"] = res

    def train():
        data, model, groups = layout or ((0, 1), (0, 1), (None, None))
        loss, net, table = train_step(training_instance(), data, model,
                                      groups)
        out["train"] = {"loss": loss, "net": net.cpu().tolist(),
                        "table": table.detach().cpu().reshape(-1).tolist()}

    for name, fn in (("fused", fused), ("adaptive", adaptive),
                     ("explore", explore), ("extended", extended),
                     ("train", train)):
        timed(name, fn)
    out["seconds"], out["launches"] = seconds, launches
    return out


def _layout(rank, nprocs):
    """This rank's ``(data, model)`` place in the 2-D layout
    (``multiprocess_dryrun.py:311``: half the ranks on the data axis when
    their number is even), and the process groups of both axes (every rank
    creates every group, in one order)."""
    import torch.distributed as dist

    d_size = nprocs // 2 if nprocs % 2 == 0 else nprocs
    m_size = nprocs // d_size
    d_idx, m_idx = divmod(rank, m_size)
    model_groups = [dist.new_group([d * m_size + m for m in range(m_size)])
                    for d in range(d_size)]
    data_groups = [dist.new_group([d * m_size + m for d in range(d_size)])
                   for m in range(m_size)]
    groups = (data_groups[m_idx] if d_size > 1 else None,
              model_groups[d_idx] if m_size > 1 else None)
    return (d_idx, d_size), (m_idx, m_size), groups


def worker(address, nprocs, rank, device, backend):
    """Join the group, run every phase over the global mesh, print one
    JSON line."""
    import safe_learning_tpu_torch as st

    from .distributed import (allreduce_latency, initialize_distributed,
                              is_coordinator, make_global_mesh,
                              shutdown_distributed)

    torch.set_num_threads(1)
    idx, count = initialize_distributed(address, nprocs, rank,
                                        backend=backend, device=device)
    try:
        if count != nprocs:
            raise AssertionError((idx, count))
        mesh = make_global_mesh()
        if st.config.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = run_phases(mesh=mesh, layout=_layout(idx, nprocs))
        out.update(pid=idx, coordinator=is_coordinator(),
                   n_ranks=count, device=str(st.config.device),
                   backend=torch.distributed.get_backend(),
                   mesh_devices=[str(d) for d in mesh.devices.flat],
                   allreduce_s=allreduce_latency())
        if st.config.device.type == "cuda":
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(json.dumps(out), flush=True)
    finally:
        shutdown_distributed()


def single_process_reference(device):
    """The same phases in this process, without a mesh."""
    import safe_learning_tpu_torch as st

    st.config.device = device
    return run_phases()


def step_departure(got, want):
    """The largest departure of a training step from another, each a dict
    of ``loss``, ``net`` and ``table`` (:func:`train_step`'s loss and
    updates): for each, the largest difference over the largest magnitude
    of ``want``'s, so that an update is held to its own scale."""
    worst = 0.0
    for key in ("loss", "net", "table"):
        a = np.asarray(got[key], np.float64).reshape(-1)
        b = np.asarray(want[key], np.float64).reshape(-1)
        worst = max(worst, float(np.max(np.abs(a - b)) / np.max(np.abs(b))))
    return worst


def check(results, ref, nprocs):
    """Raise unless every rank's phases 1-4 equal the reference's and its
    training step is within ``TRAIN_RTOL``; the instances must
    discriminate and exactly one rank be the coordinator. Returns the
    largest departure of a rank's training step."""
    if not 0 < ref["fused"]["safe_sum"] < 1024:
        raise AssertionError("the fused instance must discriminate")
    if not 0 < ref["adaptive"]["safe_sum"] < 1024:
        raise AssertionError("the adaptive instance must discriminate")
    if not ref["explore"]["count"] > 24:
        raise AssertionError("exploration appended nothing")
    worst = 0.0
    for res in results:
        if res["n_ranks"] != nprocs:
            raise AssertionError(res["n_ranks"])
        for phase in ("fused", "adaptive", "explore", "extended"):
            if res[phase] != ref[phase]:
                raise AssertionError((phase, res["pid"], res[phase],
                                      ref[phase]))
        departure = step_departure(res["train"], ref["train"])
        if not departure <= TRAIN_RTOL:
            raise AssertionError(("train", res["pid"], departure))
        worst = max(worst, departure)
    if sum(r["coordinator"] for r in results) != 1:
        raise AssertionError("exactly one coordinator")
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nprocs", type=int, default=2)
    parser.add_argument("--device", default="cuda:0",
                        help="every rank's device (cpu for a CPU run)")
    parser.add_argument("--backend", default=None,
                        help="gloo or nccl (default: nccl on a card, gloo "
                        "on the CPU)")
    parser.add_argument("--timeout", type=float, default=WORKER_TIMEOUT_S)
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--address", default=None)
    parser.add_argument("--rank", type=int, default=0)
    args = parser.parse_args(argv)

    if args.worker:
        worker(args.address, args.nprocs, args.rank, args.device,
               args.backend)
        return None

    from .distributed import free_port, run_ranks

    address = "localhost:{}".format(free_port())
    cmd = [sys.executable, "-m", "safe_learning_tpu_torch.parallel.dryrun",
           "--worker", "--nprocs",
           str(args.nprocs), "--address", address, "--device", args.device]
    if args.backend:
        cmd += ["--backend", args.backend]
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    start = time.perf_counter()
    runs, ref = run_ranks(
        [cmd + ["--rank", str(r)] for r in range(args.nprocs)],
        args.timeout, env=env,
        meanwhile=lambda: single_process_reference(args.device))
    wall = time.perf_counter() - start
    results = []
    for rank, (code, out, err) in enumerate(runs):
        if code != 0:
            sys.stderr.write(err[-4000:])
            raise SystemExit("dryrun worker {} failed (exit {})".format(
                rank, code))
        results.append(json.loads(out.strip().splitlines()[-1]))
    departure = check(results, ref, args.nprocs)
    for res in results:
        print(json.dumps({"rank": res["pid"], "device": res["device"],
                          "backend": res["backend"],
                          "seconds": res["seconds"],
                          "launches": res["launches"],
                          "allreduce_s": res["allreduce_s"],
                          "peak_bytes": res.get("peak_bytes")}))
    print("multiprocess dryrun OK: {} ranks ({}, {}) agree with the "
          "single-process run, phases 1-4 bit for bit and the training "
          "step within {!r} of its scale (limit {}; fused safe_sum={}, "
          "adaptive safe_sum={}, explore count={}, train loss={:.6g}); "
          "{:.3f} s wall".format(
              args.nprocs, results[0]["backend"], args.device, departure,
              TRAIN_RTOL,
              ref["fused"]["safe_sum"], ref["adaptive"]["safe_sum"],
              ref["explore"]["count"], ref["train"]["loss"], wall),
          flush=True)
    return results, ref


if __name__ == "__main__":
    main()
