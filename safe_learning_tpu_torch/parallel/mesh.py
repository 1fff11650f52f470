"""Device meshes for grid-sharded verification.

Counterpart of ``safe_learning_tpu/parallel/mesh.py``. The decrease check
is per point and the certified level is one global reduction, so the grid
axis is split into contiguous row ranges, one per mesh entry: each entry
runs the sweep's per-point work on its rows, and only scalars (``v_bad``,
``c_max``, whether any state is safe) are combined across entries.

A :class:`Mesh` is an array of ``torch.device``\\ s with axis names and,
for each entry, the rank of the process that owns it (all 0 in one
process; :func:`~.distributed.make_global_mesh` gives one entry per rank).
``make_mesh(devices=...)`` may repeat a device: ``["cpu"] * 8`` is the
counterpart of the JAX tests' virtual 8-device CPU mesh, and
``["cuda:0"] * k`` shards a sweep into ``k`` launches on one card.

The port's models live on ``config.device``, so a sweep over a mesh runs
each of this process's entries there: every entry a process owns must be
``config.device`` (:meth:`Mesh.check_local_devices`). Several cards are
driven by one process per card (``distributed``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "Sharding", "ShardedArray", "make_mesh", "grid_sharding",
           "replicated_sharding", "shard_points", "sharded_safe_set_update",
           "split_rows", "process_index"]


def process_index():
    """This process's rank in ``torch.distributed``'s default group (0
    when no group is initialized)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def split_rows(n, parts):
    """``parts`` contiguous ``(start, stop)`` ranges covering ``[0, n)``,
    each ``ceil(n / parts)`` long but the last ones (which may be empty),
    as a JAX sharding splits an axis."""
    n, parts = int(n), int(parts)
    size = -(-n // parts) if parts else 0
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


class Mesh:
    """An array of devices with named axes.

    Parameters
    ----------
    devices : array-like of ``torch.device`` or str
        The entries; the array's shape is the mesh's.
    axis_names : tuple of str
        One name per axis of ``devices``.
    process_indices : array-like of int, optional
        The rank owning each entry (default: every entry in this process).
    """

    def __init__(self, devices, axis_names=("grid",), process_indices=None):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError("mesh of shape {} needs {} axis names, got {}"
                             .format(shape, self.devices.ndim,
                                     self.axis_names))
        if process_indices is None:
            process_indices = np.full(shape, process_index(), dtype=int)
        self.process_indices = np.asarray(process_indices,
                                          dtype=int).reshape(shape)

    @property
    def shape(self):
        """``{axis name: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        """Number of entries."""
        return int(self.devices.size)

    @property
    def is_multiprocess(self):
        """Whether the entries belong to more than one process."""
        return len(set(self.process_indices.flat)) > 1

    def is_local(self, position):
        """Whether flat entry ``position`` belongs to this process."""
        return int(self.process_indices.flat[position]) == process_index()

    def check_local_devices(self, device):
        """Raise unless every entry of this process is ``device`` (the
        models' device, ``config.device``)."""
        device = torch.device(device)
        wrong = {str(d) for i, d in enumerate(self.devices.flat)
                 if self.is_local(i) and d != device}
        if wrong:
            raise ValueError(
                "a sweep runs its shards on config.device ({}), where the "
                "models live; this process's mesh entries include {}. Use "
                "one process per card (parallel.distributed) or entries "
                "on config.device".format(device, sorted(wrong)))

    def __repr__(self):
        return "Mesh(shape={}, devices={}, processes={})".format(
            self.shape, [str(d) for d in self.devices.flat],
            sorted(set(self.process_indices.flat)))


class Sharding:
    """Where an array's rows live on a mesh: split along the mesh axis
    ``axis`` into contiguous ranges (entries along the other axes hold
    copies), or, with ``axis=None``, whole on every entry."""

    def __init__(self, mesh, axis=None, ndim=1):
        if axis is not None and axis not in mesh.axis_names:
            raise ValueError("mesh has no axis {!r}".format(axis))
        self.mesh = mesh
        self.axis = axis
        self.ndim = int(ndim)

    @property
    def is_fully_replicated(self):
        """Whether every entry holds every row."""
        return self.axis is None or self.mesh.shape[self.axis] == 1

    def ranges(self, n):
        """The ``(start, stop)`` rows of each flat mesh entry for ``n``
        rows."""
        if self.axis is None:
            return [(0, int(n))] * self.mesh.size
        pos = self.mesh.axis_names.index(self.axis)
        shape = self.mesh.devices.shape
        split = split_rows(n, shape[pos])
        return [split[np.unravel_index(i, shape)[pos]]
                for i in range(self.mesh.size)]

    def __eq__(self, other):
        return (isinstance(other, Sharding) and other.mesh is self.mesh
                and other.axis == self.axis and other.ndim == self.ndim)

    def __repr__(self):
        return "Sharding(axis={!r}, ndim={}, {!r})".format(
            self.axis, self.ndim, self.mesh)


class ShardedArray:
    """An array's rows over a mesh: one tensor per flat mesh entry, on
    that entry's device, ``None`` for the entries of other processes.

    Attributes
    ----------
    shards : list
        Per flat entry, its rows ``sharding.ranges(shape[0])[i]``.
    sharding : Sharding
    shape : tuple
        The whole array's shape.
    dtype : torch.dtype
        The shards' dtype (known also to a process that holds no row).
    """

    def __init__(self, shards, sharding, shape, dtype):
        self.shards = list(shards)
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype

    @property
    def mesh(self):
        """The mesh the rows live on."""
        return self.sharding.mesh

    @property
    def ranges(self):
        """The ``(start, stop)`` rows of each flat entry."""
        return self.sharding.ranges(self.shape[0])

    def local(self):
        """``(position, (start, stop), tensor)`` of this process's entries
        that hold at least one row."""
        return [(i, r, s) for i, (r, s) in enumerate(zip(self.ranges,
                                                         self.shards))
                if s is not None and r[1] > r[0]]

    def gather(self, device=None):
        """The whole array on ``device`` (default ``config.device``), on
        every process (a collective when the mesh spans processes)."""
        from ..config import config
        from .distributed import gather_rows

        device = config.device if device is None else device
        if not self.sharding.is_fully_replicated and self.mesh.size > 1:
            return gather_rows(self.mesh, self.ranges, self.shards,
                               self.shape, self.dtype, device)
        whole = next(s for s in self.shards if s is not None)
        return whole.to(device)

    def numpy(self):
        """The whole array as a host numpy array, on every process."""
        return self.gather(torch.device("cpu")).numpy()


def make_mesh(n_devices=None, axis_names=("grid",), shape=None,
              devices=None):
    """Create a device mesh of this process.

    Parameters
    ----------
    n_devices : int, optional
        Number of devices to use (defaults to all of ``devices``).
    axis_names : tuple of str
        Mesh axis names; default a single ``grid`` axis.
    shape : tuple of int, optional
        Mesh shape; defaults to all devices on the first axis.
    devices : list of ``torch.device`` or str, optional
        The entries, repeats allowed (``["cpu"] * 8``, ``["cuda:0"] * 4``);
        default every visible CUDA device. Without CUDA and without
        ``devices`` this raises: a mesh is never put on the CPU unasked.
        So does a default that holds another device than
        ``config.device``, which a sweep would refuse
        (:meth:`Mesh.check_local_devices`): on a host of several cards,
        drive them with one process each (``distributed``) or name the
        entries.
    """
    default = devices is None
    if default:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= (for example ['cpu'] * 8)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError("{} devices requested, {} available".format(
                n_devices, len(devices)))
        devices = devices[:n_devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    mesh_devices = np.empty(len(devices), dtype=object)
    mesh_devices[:] = devices
    mesh = Mesh(mesh_devices.reshape(shape), axis_names)
    if default:
        from ..config import config

        mesh.check_local_devices(config.device)
    return mesh


def grid_sharding(mesh, ndim=2, axis=None):
    """Sharding that splits the leading (grid-point) axis over the mesh's
    first axis (or ``axis``)."""
    axis = mesh.axis_names[0] if axis is None else axis
    return Sharding(mesh, axis, ndim)


def replicated_sharding(mesh):
    """Fully replicated sharding."""
    return Sharding(mesh, None)


def shard_points(points, mesh, axis=None):
    """Place an ``(N, d)`` point batch sharded over the mesh's grid axis:
    each local entry gets its rows on its device, in the batch's dtype (a
    host array goes through ``torch.as_tensor``)."""
    points = torch.as_tensor(np.asarray(points)) if not torch.is_tensor(
        points) else points
    sharding = grid_sharding(mesh, points.ndim, axis)
    shards = [points[lo:hi].to(dev) if mesh.is_local(i) else None
              for i, ((lo, hi), dev) in enumerate(zip(
                  sharding.ranges(points.shape[0]), mesh.devices.flat))]
    return ShardedArray(shards, sharding, points.shape, points.dtype)


def sharded_safe_set_update(lyapunov, mesh, can_shrink=True, **kwargs):
    """Run ``lyapunov.update_safe_set`` sharded over the mesh.

    Temporarily installs the mesh on the Lyapunov object. Non-adaptive
    verifications take the fused whole-grid path; adaptive ones (or
    explicit ``max_refinement``/``batch_size`` keywords) go through
    ``update_safe_set``, whose coarse batches and refinement chunks are
    split over the mesh's entries. Returns ``(safe_set, c_max)``.
    """
    old_mesh = lyapunov.mesh
    lyapunov.mesh = mesh
    try:
        if lyapunov.adaptive or kwargs:
            lyapunov.update_safe_set(can_shrink=can_shrink, **kwargs)
        else:
            lyapunov._update_safe_set_fused(can_shrink)
    finally:
        lyapunov.mesh = old_mesh
    return lyapunov.safe_set, lyapunov.c_max
