"""Sweeps of the port over a global mesh of gloo ranks, for
``tests/test_torch_parallel.py``.

Run as a script, one process per rank::

    python tests/_torch_parallel_worker.py --address localhost:PORT \
        --world 2 --rank 0

Each rank joins the group, runs every case of :data:`CASES` over the
global mesh and, with ``--net PATH`` (a JSON file of network weights), the
dryrun's training step in float32 over its ``(data, model)`` layout of the
ranks (:func:`case_train`), and prints one JSON line of the results; the
test runs the same cases without a mesh in its own process and compares.
Imports no JAX.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import safe_learning_tpu_torch as st  # noqa: E402
from safe_learning_tpu_torch.parallel import distributed  # noqa: E402
from safe_learning_tpu_torch.parallel import dryrun  # noqa: E402


def digest(value):
    """A hash of an array's bytes (tensors through the host)."""
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    return hashlib.sha1(np.ascontiguousarray(value).tobytes()).hexdigest()


def state(lyap):
    """What every rank must hold after a sweep."""
    return {"safe": digest(np.asarray(lyap.safe_set)),
            "safe_sum": int(np.sum(lyap.safe_set)),
            "refinement": digest(lyap._refinement),
            "values": digest(lyap.values), "c_max": float(lyap.c_max)}


def linear_instance():
    """``tests/test_sharding.py::_make_lyapunov`` in the port."""
    grid = st.GridWorld([[-1, 1], [-1, 1]], [32, 32])
    policy = st.LambdaFunction(lambda x: 0.0 * x[:, :1])
    dyn = st.LinearSystem([np.array([[0.8, 0.1], [0.0, 0.7]]),
                           np.zeros((2, 1))])
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), dyn, 0.8,
                       1.0, 1e-4, policy,
                       initial_set=[grid.nindex // 2 + 16])


def adaptive_instance():
    """``tests/test_sharding.py``'s adaptive 33x33 instance: at tau = 4e-3
    the innermost ring fails the coarse check and verifies at tau / 4."""
    grid = st.GridWorld([[-1, 1], [-1, 1]], [33, 33])
    policy = st.LambdaFunction(lambda x: 0.0 * x[:, :1])
    dyn = st.LinearSystem([np.array([[0.92, 0.0], [0.0, 0.9]]),
                           np.zeros((2, 1))])
    lv = st.LambdaFunction(lambda x: 2.0 * torch.abs(x))
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), dyn, 0.95,
                       lv, 4e-3, policy, initial_set=[grid.nindex // 2],
                       adaptive=True)


def tie_instance():
    """A 17x17 grid (steps of 1/8, exact) on which every state with ``x0 >
    0`` fails (``f(x) = x`` there, ``x / 2`` elsewhere, ``tau = 0``): the
    first failing state in value order is ``(1/8, 0)`` (flat index 161,
    ``v = 1/64``), and the states tied with it below that index,
    ``(-1/8, 0)``, ``(0, -1/8)`` and ``(0, 1/8)`` (127, 143, 145), are
    certified. In batches of 8 over two ranks the first rank holds rows
    0-151: the tie crosses the ranks."""
    grid = st.GridWorld([[-1, 1], [-1, 1]], [17, 17])
    policy = st.LambdaFunction(lambda x: 0.0 * x[:, :1])
    dyn = st.LambdaFunction(lambda z: torch.where(
        z[:, :1] > 0, z[:, :2], 0.5 * z[:, :2]))
    return st.Lyapunov(grid, st.QuadraticFunction(np.eye(2)), dyn, 1.0, 1.0,
                       0.0, policy, initial_set=[grid.nindex // 2])


def case_fused(mesh):
    """The fused sweep, and with a per-point margin."""
    lyap = linear_instance()
    lyap.mesh = mesh
    lyap.update_safe_set()
    out = {"plain": state(lyap)}
    lyap.certificate_margin = np.linspace(0.0, 2e-3,
                                          lyap.discretization.nindex)
    lyap.level_margin = 1e-3
    lyap.update_safe_set()
    out["margins"] = state(lyap)
    return out


def case_sorted(mesh):
    """The adaptive sweep at refinement 4 in batches of 100 (rounded to
    the mesh's unit), the values in batches of 100, then a fused
    ``can_shrink=False`` pass."""
    lyap = adaptive_instance()
    lyap.mesh = mesh
    lyap.update_safe_set(max_refinement=4, batch_size=100)
    out = {"refined": state(lyap)}
    lyap.update_values(batch_size=100)
    out["values_batched"] = digest(lyap.values)
    lyap.adaptive = False
    lyap.update_safe_set(can_shrink=False)
    out["kept"] = state(lyap)
    return out


def case_streamed(mesh):
    """The streamed sweep in batches of 8, with the tie at ``v_bad``, then
    with a level margin."""
    old = st.config.fused_sweep_limit
    st.config.fused_sweep_limit = 8
    try:
        lyap = tie_instance()
        lyap.mesh = mesh
        lyap.update_safe_set(batch_size=8)
        out = {"tie": state(lyap), "bad": list(lyap.last_stream_bad)}
        lyap.level_margin = 0.005
        lyap.update_safe_set(batch_size=8)
        out["margin"] = state(lyap)
    finally:
        st.config.fused_sweep_limit = old
    return out


def case_extended(mesh):
    """The extended and the hybrid sweeps of the dryrun's GP instance,
    adaptive at refinement 2 (float64 refined chunks over the ranks)."""
    from safe_learning_tpu_torch.ops.extended_verify import (
        extended_certificate_margin)

    lyap, _ = dryrun.build_gp_instance(adaptive=True)
    lyap.mesh = mesh
    lyap.extended_lv_matrix = 2.0 * np.eye(2)
    extended_certificate_margin(lyap, lv_matrix=lyap.extended_lv_matrix)
    lyap.update_safe_set(extended=True, max_refinement=2)
    out = {"extended": state(lyap)}
    lyap.safe_set = np.array(lyap.initial_safe_set)
    lyap.update_safe_set(extended="hybrid", max_refinement=2)
    out["hybrid"] = state(lyap)
    out["band_fraction"] = lyap.last_band_fraction
    return out


def case_tiny(mesh):
    """A 2-state grid: over 3 or more shards some hold no row (and some
    ranks none) in the fused, the sorted and the streamed sweep."""
    grid = st.GridWorld([[-1, 1]], 2)
    out = {}
    old = st.config.fused_sweep_limit
    try:
        for name, adaptive, limit in (("fused", False, old),
                                      ("sorted", True, old),
                                      ("streamed", False, 1)):
            st.config.fused_sweep_limit = limit
            lyap = st.Lyapunov(grid, st.QuadraticFunction(np.eye(1)),
                               st.LinearSystem([np.array([[0.5]]),
                                                np.zeros((1, 1))]), 0.5,
                               2.0, 0.0, st.LinearSystem(np.zeros((1, 1))),
                               adaptive=adaptive, mesh=mesh)
            lyap.update_safe_set(max_refinement=2,
                                 batch_size=1 if limit == 1 else None)
            out[name] = state(lyap)
    finally:
        st.config.fused_sweep_limit = old
    return out


def case_train(rank, world, weights):
    """``dryrun.train_step`` in float32 on the network of ``weights``
    (``convert.lyapunov_network``'s ``eps``, ``posdef_weights`` and
    ``extra_weights``), this rank placed as the dryrun places it
    (``dryrun._layout``): over 4 ranks 2 data x 2 model, over 2 the model
    axis alone, over 3 the data axis alone."""
    from safe_learning_tpu_torch import convert

    old = st.config.dtype
    st.config.dtype = torch.float32
    try:
        net = convert.lyapunov_network(
            2, [4, 4], ["tanh", "tanh"], weights["eps"],
            *[[None if w is None else np.asarray(w) for w in weights[k]]
              for k in ("posdef_weights", "extra_weights")])
        data, model, groups = dryrun._layout(rank, world)
        loss, net_update, table_update = dryrun.train_step(
            dryrun.training_instance(net), data, model, groups)
    finally:
        st.config.dtype = old
    return {"layout": [list(data), list(model)], "loss": loss,
            "net": net_update.tolist(),
            "table": table_update.reshape(-1).tolist()}


CASES = {"fused": case_fused, "sorted": case_sorted,
         "streamed": case_streamed, "extended": case_extended,
         "tiny": case_tiny}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--address", required=True)
    parser.add_argument("--world", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--dtype", default="float64")
    parser.add_argument("--net", default=None)
    args = parser.parse_args()
    torch.set_num_threads(1)
    st.config.dtype = getattr(torch, args.dtype)
    distributed.initialize_distributed(args.address, args.world, args.rank,
                                       backend="gloo", device="cpu",
                                       timeout=60)
    try:
        mesh = distributed.make_global_mesh()
        out = {name: fn(mesh) for name, fn in CASES.items()}
        # Rank 0's host data reaches every rank unchanged.
        mine = ({"xu": np.random.default_rng(5).normal(size=(3, 3)),
                 "k": 7} if distributed.is_coordinator() else None)
        got = distributed.broadcast_from_coordinator(mine)
        out["broadcast"] = [digest(got["xu"]), got["k"]]
        points = distributed.global_grid_points(
            linear_instance().discretization, mesh)
        out["points"] = digest(distributed.fetch_global(points))
        out["local_rows"] = [list(r) for _, r, _ in points.local()]
        if args.net:
            with open(args.net) as f:
                out["train"] = case_train(args.rank, args.world, json.load(f))
        print(json.dumps(out), flush=True)
    finally:
        distributed.shutdown_distributed()


if __name__ == "__main__":
    main()
