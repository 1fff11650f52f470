"""Multi-process execution over ``torch.distributed``.

Counterpart of ``safe_learning_tpu/parallel/distributed.py``.
``parallel/mesh.py`` covers the meshes of one process; several processes
(one per card, or several on one card for a check) join one process group
and each drives its own entries of a global mesh:

- :func:`initialize_distributed` joins the group (``init_process_group``
  over ``tcp://``, with a timeout so that a lost rank fails the run);
- :func:`make_global_mesh`: one entry per rank, each rank's own device;
- :func:`global_grid_points` / :func:`global_array` / :func:`put_global`:
  each process makes only its own shards (the grid's from
  ``GridWorld.states_in_range`` on its device: no host holds the whole
  grid);
- :func:`fetch_global` gathers a sharded array onto every process and
  :func:`broadcast_from_coordinator` sends host data from rank 0;
- :func:`sharded_decrease_check` / :func:`sharded_certified_level`: the
  fused sweep over a global mesh.

The sweeps keep host logic replicated and device work sharded: every rank
runs the same host code on the same host state, each checks its rows, and
the ranks exchange scalars (:func:`reduce_scalars`) and, where the host
needs every row, the rows (:func:`gather_rows`). Over gloo, which moves
CUDA tensors only in ``broadcast`` and ``all_reduce``, both stage through
host tensors; over NCCL they stay on the card.

:func:`free_port` and :func:`run_ranks` start ranks as child processes on
a free local port, each with a time limit.
"""

from __future__ import annotations

import datetime
import socket
import subprocess

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, ShardedArray, Sharding, grid_sharding, process_index

__all__ = ["initialize_distributed", "shutdown_distributed",
           "make_global_mesh", "global_array", "global_grid_points",
           "is_coordinator", "fetch_global", "put_global",
           "broadcast_from_coordinator", "is_multiprocess_mesh",
           "sharded_decrease_check", "sharded_certified_level",
           "reduce_scalars", "reduce_tensor", "gather_rows",
           "allreduce_latency", "free_port", "run_ranks"]

#: Seconds a collective (the rendezvous included) waits for a rank.
DEFAULT_TIMEOUT_S = 120


def is_multiprocess_mesh(mesh):
    """Whether ``mesh`` has entries of more than one process."""
    return mesh is not None and mesh.is_multiprocess


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, backend=None, device=None,
                           timeout=DEFAULT_TIMEOUT_S):
    """Join the process group; return ``(process_id, count)``.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://`` may be
    given); ``None`` reads the ``MASTER_ADDR`` environment (``env://``).
    ``device`` (default ``config.device``) becomes this rank's
    ``config.device``, and the current CUDA device for a card. ``backend``
    defaults to NCCL for a card and gloo for the CPU; NCCL refuses two
    ranks on one card, so several ranks sharing a card use gloo.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    """
    from ..config import config

    if device is not None:
        config.device = device
    device = config.device
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed():
    """Leave the process group, if one is initialized."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator():
    """Whether this is rank 0 (gate host-side state on it)."""
    return process_index() == 0


def _world_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_global_mesh(axis_names=("grid",), shape=None, device=None):
    """A mesh over every rank, one entry each: rank ``r``'s entry is its
    device (``device``, default ``config.device``, exchanged once).
    ``shape`` defaults to every rank on the first axis."""
    from ..config import config

    device = str(torch.device(device) if device is not None
                 else config.device)
    world = _world_size()
    names = [device]
    if world > 1:
        names = [None] * world
        dist.all_gather_object(names, device)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    devices = np.empty(world, dtype=object)
    devices[:] = names
    return Mesh(devices.reshape(shape), axis_names,
                process_indices=np.arange(world).reshape(shape))


def _comm_device():
    """Where collectives stage their tensors: the card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _check_group(mesh):
    ranks = set(int(p) for p in mesh.process_indices.flat)
    if ranks != set(range(_world_size())):
        raise ValueError("a multi-process mesh must hold every rank of "
                         "the process group; it holds {}".format(
                             sorted(ranks)))


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def reduce_scalars(values, op, mesh):
    """Numbers reduced elementwise over the mesh's processes (``op``:
    ``"sum"``, ``"min"`` or ``"max"``) in float64; a list. On a mesh of
    one process (or none) the numbers come back as they are."""
    values = [float(v) for v in values]
    if not is_multiprocess_mesh(mesh):
        return values
    _check_group(mesh)
    t = torch.tensor(values, dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]))
    return t.tolist()


def reduce_tensor(tensor, op="sum", group=None):
    """A new tensor: ``tensor`` reduced elementwise over ``group`` (default
    every rank), staged on :func:`_comm_device`, on ``tensor``'s device."""
    t = tensor.detach().to(_comm_device(), copy=True)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return t.to(tensor.device)


def gather_rows(mesh, ranges, shards, shape, dtype, device):
    """The whole array from its row shards, on ``device``, on every
    process: ``shards[i]`` holds rows ``ranges[i]`` (``None`` on the
    processes that do not own entry ``i``). Across processes each range is
    broadcast by its owner, once, staged on :func:`_comm_device`; booleans
    travel as bytes."""
    device = torch.device(device)
    if not is_multiprocess_mesh(mesh):
        out = torch.empty(shape, dtype=dtype, device=device)
        for (lo, hi), s in zip(ranges, shards):
            if hi > lo:
                out[lo:hi] = s
        return out
    _check_group(mesh)
    wire = torch.uint8 if dtype == torch.bool else dtype
    buf = torch.empty(shape, dtype=wire, device=_comm_device())
    me = process_index()
    seen = set()
    for i, ((lo, hi), s) in enumerate(zip(ranges, shards)):
        if hi <= lo or (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        owner = int(mesh.process_indices.flat[i])
        view = buf[lo:hi]
        if owner == me:
            view.copy_(s.view(torch.uint8) if dtype == torch.bool else s)
        dist.broadcast(view, src=owner)
    if dtype == torch.bool:
        buf = buf.view(torch.bool)
    return buf.to(device)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _as_sharding(mesh, spec, ndim):
    if isinstance(spec, Sharding):
        return spec
    if spec is None:
        return grid_sharding(mesh, ndim)
    return Sharding(mesh, spec, ndim)


def global_array(shape, dtype, mesh, fill, spec=None):
    """A sharded array whose shards each process fills itself.

    ``fill(index)`` gets the numpy-style index (a tuple of slices) of one
    shard of the whole array and returns its data (host or tensor),
    called only for this process's entries; each shard is cast to
    ``dtype`` on its entry's device. ``spec`` is a :class:`Sharding` or
    the name of the mesh axis the rows split over (default the first).
    """
    sharding = _as_sharding(mesh, spec, len(shape))
    dtype = _torch_dtype(dtype)
    rest = (slice(None),) * (len(shape) - 1)
    shards = []
    for i, ((lo, hi), dev) in enumerate(zip(sharding.ranges(shape[0]),
                                            mesh.devices.flat)):
        if not mesh.is_local(i):
            shards.append(None)
            continue
        data = fill((slice(lo, hi),) + rest)
        if not torch.is_tensor(data):
            data = torch.as_tensor(np.asarray(data))
        shards.append(data.to(device=dev, dtype=dtype))
    return ShardedArray(shards, sharding, shape, dtype)


def put_global(host_array, sharding):
    """Place a host array, the same on every process, onto a sharding:
    each process keeps only its entries' rows."""
    host_array = np.asarray(host_array)
    return global_array(host_array.shape, host_array.dtype, sharding.mesh,
                        lambda index: host_array[index], spec=sharding)


def global_grid_points(grid, mesh):
    """The grid's points as a sharded ``(nindex, ndim)`` array in the
    working dtype: each process makes its entries' rows on their devices
    (``GridWorld.states_in_range``, bit for bit ``all_points``' rows)."""
    from ..config import config

    sharding = grid_sharding(mesh, 2)
    shards = [grid.states_in_range(lo, hi, dev) if mesh.is_local(i)
              else None
              for i, ((lo, hi), dev) in enumerate(zip(
                  sharding.ranges(grid.nindex), mesh.devices.flat))]
    return ShardedArray(shards, sharding, (grid.nindex, grid.ndim),
                        config.dtype)


def fetch_global(array):
    """A (possibly sharded) array gathered onto every host as numpy."""
    if isinstance(array, ShardedArray):
        return array.numpy()
    if torch.is_tensor(array):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def broadcast_from_coordinator(tree):
    """Rank 0's host data (numpy arrays, numbers, containers of them) on
    every rank: the exploration choices made on the coordinator reach
    every rank unchanged, so no per-rank random stream can make the
    learned state diverge. No-op in one process."""
    if _world_size() == 1:
        return tree
    box = [tree if is_coordinator() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def sharded_decrease_check(lyapunov, mesh):
    """The margin-guarded decrease verdicts and the values of the whole
    grid over a (global) mesh: ``(negative, values)`` as sharded arrays
    (:func:`fetch_global` brings them to the host)."""
    from ..lyapunov import _negative_batch, _values_batch

    lyapunov._require_f32_margin()
    points = global_grid_points(lyapunov.discretization, mesh)
    margin = lyapunov.certificate_margin
    negative = [None] * mesh.size
    values = [None] * mesh.size
    for pos, (lo, hi), pts in points.local():
        negative[pos] = _negative_batch(
            lyapunov.policy, lyapunov.dynamics, lyapunov.lyapunov_function,
            lyapunov._lipschitz_lyapunov, lyapunov._lipschitz_dynamics,
            lyapunov.tau, pts,
            margin if np.ndim(margin) == 0 else margin[lo:hi])[0]
        values[pos] = _values_batch(lyapunov.lyapunov_function, pts)
    n = lyapunov.discretization.nindex
    return (ShardedArray(negative, grid_sharding(mesh, 1), (n,), torch.bool),
            ShardedArray(values, grid_sharding(mesh, 1), (n,),
                         next((v.dtype for v in values if v is not None),
                              points.dtype)))


def sharded_certified_level(lyapunov, mesh, can_shrink=True):
    """The fused certified-level update over a (global) mesh; returns
    ``(safe_set, c_max)``. ``lyapunov``'s ``safe_set``, ``c_max``,
    ``values`` and refinement levels are updated as by
    ``update_safe_set(can_shrink=can_shrink)``, the same on every rank;
    every rank must hold the same host state."""
    lyapunov._require_f32_margin()
    old_mesh = lyapunov.mesh
    lyapunov.mesh = mesh
    try:
        lyapunov._update_safe_set_fused(can_shrink)
    finally:
        lyapunov.mesh = old_mesh
    return lyapunov.safe_set, lyapunov.c_max


def allreduce_latency(reps=50):
    """Median seconds of one all-reduce of one float64 over every rank,
    staged as the sweeps stage their scalars (:func:`_comm_device`),
    after 5 warm-up calls; a card's stream is synchronised after each."""
    import statistics
    import time

    t = torch.ones(1, dtype=torch.float64, device=_comm_device())
    times = []
    for i in range(reps + 5):
        start = time.perf_counter()
        dist.all_reduce(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        if i >= 5:
            times.append(time.perf_counter() - start)
    return statistics.median(times)


def free_port():
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_ranks(commands, timeout, env=None, meanwhile=None):
    """Run one child process per command at once; return ``[(returncode,
    stdout, stderr)]`` and what ``meanwhile()`` (called here while they
    run) returned. Their output goes to temporary files, so that no child
    blocks on a full pipe while another waits for it in a collective. Each
    is waited for within ``timeout`` seconds of the start; on a timeout
    every child still running is killed and ``subprocess.TimeoutExpired``
    raised."""
    import tempfile
    import time

    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in commands]
    procs = [subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                              env=env)
             for cmd, (out, err) in zip(commands, files)]
    deadline = time.monotonic() + timeout
    try:
        extra = meanwhile() if meanwhile is not None else None
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        results = []
        for proc, (out, err) in zip(procs, files):
            out.seek(0)
            err.seek(0)
            results.append((proc.returncode, out.read(), err.read()))
        return results, extra
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for out, err in files:
            out.close()
            err.close()
