"""Device meshes and distributed bring-up (counterpart of the JAX package's
parallel/mesh.py).

JAX hands a ``Mesh`` to sharding annotations and lets XLA's partitioner
split the work and insert the collectives.  Here the split and the
reductions are explicit: ``map_batch`` runs a function on each shard of a
batch's leading axis on the shard's device and gathers the results onto
the first device in shard order; ``reduce_sum`` adds per-shard partial sums
there in shard order.  Both are fixed-order and use no atomics, so a run
repeats bit for bit, and on a mesh of one device they hand the work through
untouched: the arithmetic is the unsharded one.

A mesh may span processes (``initialize_distributed``): each process runs
its own shards, which are numbered ``rank * local + j``, and the gather and
the reduction cross the process boundary with ``torch.distributed``
(``all_gather``, ``all_reduce``).  NCCL takes CUDA tensors only; gloo takes
host tensors, so what crosses a gloo group is staged through the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None) -> str | None:
    """Join ``num_processes`` processes over ``tcp://coordinator`` (process
    0 listens there).  A no-op for a single process (returns None).  The
    backend is NCCL when the processes run on CUDA and each has a card of
    its own (the card ``process_id`` mod the card count becomes current),
    gloo otherwise: on the CPU, and when processes share a card (NCCL
    refuses two ranks on one device).  Returns the backend's name."""
    if num_processes is None or num_processes <= 1:
        return None
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= num_processes:
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return backend


class Mesh:
    """The shards of a mesh that this process runs: ``devices`` holds their
    devices reshaped to the local shape (the global shape with its first
    axis divided by the process count), ``axis_names`` names the axes and
    ``group`` is the process group when the mesh spans processes."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.local_devices = [torch.device(d) for d in devices.flat]
        self.size = len(self.local_devices) * self.world
        self.first_shard = self.rank * len(self.local_devices)
        gshape = (devices.shape[0] * self.world,) + devices.shape[1:]
        self.shape = dict(zip(self.axis_names, gshape))

    @property
    def device(self) -> torch.device:
        """Where gathered results and reductions land."""
        return self.local_devices[0]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices={self.local_devices}, "
                f"processes={self.world})")


def make_mesh(shape: tuple = (), axis_names: tuple = (),
              devices=None) -> Mesh:
    """Build a mesh.  () → every device on one "batch" axis.  ``devices``
    None takes the machine's CUDA cards, from the current one on, and
    raises when the mesh needs more than there are (JAX's rule); an
    explicit list may repeat a device (``[torch.device("cpu")] * 8`` is a
    virtual 8-device mesh).  Under an initialized process group the mesh
    spans every process and ``devices`` are this process's."""
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             and dist.get_world_size() > 1 else None)
    world = dist.get_world_size() if group is not None else 1
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_mesh: no CUDA card (pass devices= for a "
                             "mesh of CPU shards)")
        first = torch.cuda.current_device()
        devices = [torch.device("cuda", i)
                   for i in range(first, torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if not shape:
        shape = (len(devices) * world,)
        axis_names = axis_names or ("batch",)
    if not axis_names:
        axis_names = tuple(f"axis{i}" for i in range(len(shape)))
    n = math.prod(shape)
    if shape[0] % world:
        raise ValueError(f"mesh {shape}: first axis not divisible by "
                         f"{world} processes")
    local = n // world
    if local > len(devices):
        raise ValueError(f"mesh {shape} needs {local} devices, have "
                         f"{len(devices)}")
    arr = np.empty(local, dtype=object)
    arr[:] = devices[:local]
    return Mesh(arr.reshape((shape[0] // world,) + tuple(shape[1:])),
                axis_names, group)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero rows appended so the leading axis is a multiple of ``n``."""
    pad = -x.shape[0] % n
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def batch_sharding(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """This process's shards of ``x``'s leading axis, each on its device:
    the axis is zero-padded to a multiple of the mesh size and cut into
    that many equal blocks, in shard order."""
    x = _pad_rows(x, mesh.size)
    per = x.shape[0] // mesh.size
    return [x[(mesh.first_shard + j) * per:(mesh.first_shard + j + 1) * per]
            .to(d) for j, d in enumerate(mesh.local_devices)]


def replicated(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """A copy of ``x`` on each of this process's shard devices."""
    return [x.to(d) for d in mesh.local_devices]


def _host_staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """What a collective of ``mesh.group`` takes: gloo takes host tensors,
    NCCL CUDA ones; bool crosses as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if dist.get_backend(mesh.group) == "gloo":
        t = t.cpu()
    return t.contiguous()


def _all_gather_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (equal shapes) concatenated in rank order."""
    s = _host_staged(mesh, t)
    parts = [torch.empty_like(s) for _ in range(mesh.world)]
    dist.all_gather(parts, s, group=mesh.group)
    return torch.cat(parts).to(device=t.device, dtype=t.dtype)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the mesh's processes (itself for one process).
    Every rank receives the same bits."""
    if mesh.group is None:
        return t
    s = _host_staged(mesh, t)
    s = s.clone() if s is t else s
    dist.all_reduce(s, group=mesh.group)
    return s.to(device=t.device, dtype=t.dtype)


def _gather_tensors(mesh: Mesh, parts: list, n_rows: int) -> torch.Tensor:
    local = torch.cat([p.to(mesh.device) for p in parts])
    if mesh.group is not None:
        local = _all_gather_rows(mesh, local)
    return local[:n_rows]


def gather(mesh: Mesh, outs: list, n_rows: int):
    """Per-shard outputs (tensors, or tuples/dicts of tensors with the
    shard's leading axis) concatenated in shard order on the first device,
    across processes too, and cut to ``n_rows``."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _gather_tensors(mesh, [o[k] for o in outs], n_rows)
                for k in first}
    if isinstance(first, tuple):
        return tuple(_gather_tensors(mesh, [o[i] for o in outs], n_rows)
                     for i in range(len(first)))
    return _gather_tensors(mesh, outs, n_rows)


def map_batch(mesh: Mesh | None, fn, split: tuple, repl: tuple = ()):
    """``fn(*repl, *split)`` over the mesh: the leading axis of each
    ``split`` tensor is sharded (``batch_sharding``), ``repl`` is copied to
    each shard's device, ``fn`` runs once per shard there, and the outputs
    are gathered in shard order onto the first device.  Without a mesh, or
    on a mesh of one device in one process, ``fn`` runs on the inputs as
    they are."""
    if mesh is None or mesh.size == 1:
        return fn(*repl, *split)
    n_rows = split[0].shape[0]
    shards = [batch_sharding(mesh, x) for x in split]
    copies = [replicated(mesh, x) for x in repl]
    outs = [fn(*(c[j] for c in copies), *(s[j] for s in shards))
            for j in range(len(mesh.local_devices))]
    return gather(mesh, outs, n_rows)


def reduce_sum(mesh: Mesh | None, parts: list) -> torch.Tensor:
    """Per-shard partial sums added on the first device in shard order,
    then over the processes.  One part is returned as it is."""
    if len(parts) == 1 and (mesh is None or mesh.group is None):
        return parts[0]
    dev = parts[0].device if mesh is None else mesh.device
    total = parts[0].to(dev)
    for p in parts[1:]:
        total = total + p.to(dev)
    return total if mesh is None else all_reduce_sum(mesh, total)
