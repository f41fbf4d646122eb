"""The ``(pods, grants)`` device mesh of the sharded paths, on ``torch.distributed``.

The port of ``kubernetes_verification_tpu.parallel.mesh``. JAX's
``shard_map`` runs one body per device under one controller; here the
sharded paths run SPMD: one process per rank, every rank calls the same
entry point with the same encoding, works on its own slices and gets the
same global result back. The mesh is a 2-D ``DeviceMesh`` whose dims are
the two big problem dimensions:

* ``"pods"`` — the N axis. Rows of every pod-indexed array (and of the N×N
  reachability matrix) split across it; its collectives are gathers of the
  destination-side blocks.
* ``"grants"`` — the flattened (policy, rule, peer) axis. Each rank
  evaluates a slice of the grant stack; the OR over grants is a sum over
  this dim's process group.

Each ``in_specs`` of the JAX package becomes slicing by the rank's mesh
coordinates (``Mesh.coords``), each ``out_specs`` a gather, and each
``jax.lax.psum`` / ``all_gather`` one of the named collectives below on the
dim's process group. On a CUDA device the process group is NCCL, on the
CPU gloo; ``backend="gloo"`` over CUDA tensors runs several ranks on one
card (NCCL refuses two ranks on one GPU; torch 2.11's gloo takes CUDA
tensors in the three collectives used here, so nothing is staged through
the host). No collective moves ``bool`` (NCCL has none): gathers move
``uint8`` (``bool`` and ``int8`` as a ``uint8`` view), sums ``int32``,
packed words travel as ``int32``.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.padding import pad_rows
from ..resilience.errors import ConfigError
from ..runtime import resolve_device

__all__ = [
    "POD_AXIS",
    "GRANT_AXIS",
    "Mesh",
    "mesh_for",
    "distributed_mesh",
    "init_distributed",
    "leave_distributed",
    "all_gather",
    "gather_rows",
    "psum",
    "psum_counts",
    "broadcast",
    "barrier",
    "pad_rows",
    "pad_amount",
    "rank_slice",
]

POD_AXIS = "pods"
GRANT_AXIS = "grants"

#: both dims at once: a sum over every rank of the mesh
BOTH = (POD_AXIS, GRANT_AXIS)

_MESHES: Dict[tuple, "Mesh"] = {}


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", 0))
    return rank % max(1, torch.cuda.device_count())


def _mesh_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` or ``cuda`` without an
    index is ``cuda:<local rank>``, and a CUDA device raises
    ``BackendError`` without a GPU (``runtime.resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return dev


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
) -> bool:
    """Join (or make) the process group of the sharded paths — the port of
    JAX's ``init_distributed`` (``jax.distributed.initialize`` behind an
    idempotent guard).

    With ``init_method`` / ``world_size`` / ``rank`` it joins that job
    (``tcp://localhost:<port>``, any free port). Without them it joins the
    job a launcher describes in ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
    (``env://``, as ``torchrun`` sets it), and with none of those it makes a
    1-rank group on a local store: JAX's single-process no-op, except that
    the collectives really run, at world size 1. An initialised group is
    left as it is.

    The backend follows the device (``device=None`` is ``cuda:<local
    rank>``, and raises ``BackendError`` without a GPU): NCCL for ``cuda``,
    gloo for ``cpu``; ``backend="gloo"`` picks gloo over CUDA tensors.
    Returns True when the job has more than one rank."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    dev = _mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = timedelta(seconds=timeout_s)
    if init_method is not None or world_size is not None:
        if world_size is None or rank is None:
            raise ConfigError("init_distributed needs world_size and rank with init_method")
        dist.init_process_group(
            backend, init_method=init_method or "env://", world_size=world_size,
            rank=rank, timeout=timeout,
        )
    elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(
            backend, store=dist.HashStore(), world_size=1, rank=0, timeout=timeout
        )
    return dist.get_world_size() > 1


def leave_distributed() -> None:
    """Leave this process's group and forget the meshes made on it (a
    later ``mesh_for`` joins a new group)."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return 1


class Mesh:
    """A ``(pods, grants)`` mesh over every rank of the job: the
    ``DeviceMesh``, its shape as the JAX code reads it (``mesh.shape[
    POD_AXIS]``), this rank's coordinates (``coords[POD_AXIS]``), each
    dim's process group and the rank's ``device``. Rank ``r`` sits at
    ``(r // mp, r % mp)``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        dp, mp = device_mesh.mesh.shape
        self.shape = {POD_AXIS: int(dp), GRANT_AXIS: int(mp)}
        coord = device_mesh.get_coordinate()
        self.coords = {POD_AXIS: int(coord[0]), GRANT_AXIS: int(coord[1])}
        self.groups = {
            POD_AXIS: device_mesh.get_group(POD_AXIS),
            GRANT_AXIS: device_mesh.get_group(GRANT_AXIS),
            BOTH: dist.group.WORLD,
        }
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()

    def global_rank(self, pod: int, grant: int) -> int:
        return int(self.device_mesh.mesh[pod, grant])

    def __repr__(self) -> str:
        return (f"Mesh(pods={self.shape[POD_AXIS]}, grants={self.shape[GRANT_AXIS]}, "
                f"coords={self.coords}, device={self.device}, backend={self.backend})")


def mesh_for(
    shape: Optional[Union[int, Tuple[int, int]]] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> Mesh:
    """Build (or reuse) a ``(pods, grants)`` mesh over every rank of the job.

    ``shape=None`` puts every rank on the pod axis — the N×N matrix
    dominates memory and the pod axis dominates the work; ``(dp, mp)``
    spreads the grant stack too; a bare int ``n`` means ``(n, 1)``. A shape
    whose product differs from the job's world size raises ``ConfigError``
    (it never shrinks silently). ``device=None`` is ``cuda:<local rank>``
    and raises ``BackendError`` without a GPU. Joins the job first
    (``init_distributed``) when this process has none; a 1-rank job when no
    launcher describes one. Every rank must make the same ``mesh_for``
    calls in the same order (a new shape makes process groups)."""
    dev = _mesh_device(device)
    world = _world_size()
    if shape is None:
        shape = (world, 1)
    elif isinstance(shape, (int, np.integer)):
        shape = (int(shape), 1)
    dp, mp = (int(v) for v in shape)
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ConfigError(f"mesh shape {tuple(shape)} != {world} ranks")
    init_distributed(device=dev, backend=backend)
    key = (id(dist.group.WORLD), dp, mp, str(dev), dist.get_backend())
    mesh = _MESHES.get(key)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh(dev.type, (dp, mp), mesh_dim_names=(POD_AXIS, GRANT_AXIS))
        mesh = _MESHES[key] = Mesh(dm, dev)
    return mesh


def distributed_mesh(
    shape: Optional[Union[int, Tuple[int, int]]] = None,
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> Mesh:
    """The multi-process entry point: ``init_distributed`` then
    ``mesh_for`` over the job's ranks. A job of one rank per card runs, per
    process (``torchrun --nproc-per-node 8 my_job.py``)::

        mesh = distributed_mesh((8, 1))

    and passes the mesh to ``sharded_packed_reach`` or the ``sharded`` /
    ``sharded-packed`` backends, exactly as the gloo CPU ranks of the tests
    do."""
    init_distributed(init_method, world_size, rank, backend=backend, device=device)
    return mesh_for(shape, device=device, backend=backend)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the members'
    blocks of ``x`` over ``axis``'s group, in member order, concatenated
    along ``dim``. ``bool`` and ``int8`` travel as ``uint8``."""
    dtype = x.dtype
    if dtype == torch.bool:
        src = x.to(torch.uint8).contiguous()
    elif dtype == torch.int8:
        src = x.contiguous().view(torch.uint8)
    else:
        src = x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=mesh.groups[axis])
    out = torch.cat(parts, dim=dim)
    if dtype == torch.bool:
        return out.to(torch.bool)
    return out.view(torch.int8) if dtype == torch.int8 else out


def gather_rows(mesh: Mesh, x: torch.Tensor, ids, block: int, axis: str = POD_AXIS) -> torch.Tensor:
    """Rows ``ids`` of a tensor split over ``axis`` in blocks of ``block``
    rows, on every member: ``x`` is this rank's block, ``ids`` the global
    row numbers (host ints, the same on every rank), the result ``[K,
    ...]`` in the order of ``ids``. Each owner contributes only its own
    rows, padded to the most any member owns, in one ``all_gather``; no
    collective runs when ``ids`` is empty (on every rank alike)."""
    ids = np.asarray(ids, dtype=np.int64)
    if not ids.size:
        return x[:0]
    owner = ids // block
    k = mesh.shape[axis]
    counts = np.bincount(owner, minlength=k)
    kmax = int(counts.max())
    me = mesh.coords[axis]
    mine = torch.as_tensor(ids[owner == me] - me * block, device=x.device)
    src = x[mine]
    if src.shape[0] < kmax:
        src = torch.cat([src, src.new_zeros((kmax - src.shape[0], *src.shape[1:]))])
    gathered = all_gather(mesh, src, axis, dim=0)  # [k · kmax, ...]
    # each id's place: its owner's block, then its rank among that owner's ids
    seen = np.zeros(k, dtype=np.int64)
    pos = np.empty(ids.size, dtype=np.int64)
    for j, o in enumerate(owner):
        pos[j] = o * kmax + seen[o]
        seen[o] += 1
    return gathered[torch.as_tensor(pos, device=x.device)]


def _in_place(x: torch.Tensor, collective) -> torch.Tensor:
    """Run ``collective`` on ``x`` in place. A collective reads a tensor's
    storage as one dense block, so a strided view (a sliced ``bool_dot``
    result, say) goes through a contiguous copy."""
    buf = x if x.is_contiguous() else x.contiguous()
    collective(buf)
    if buf is not x:
        x.copy_(buf)
    return x


def psum(mesh: Mesh, x: torch.Tensor, axis) -> torch.Tensor:
    """``jax.lax.psum(x, axis)`` in place on ``x`` (returned): the sum over
    ``axis``'s group, or over every rank for ``(POD_AXIS, GRANT_AXIS)``.
    Integer sums are exact; ``bool`` is refused (NCCL has no bool)."""
    if x.dtype == torch.bool:
        raise ConfigError("psum of bool: sum an integer view instead")
    group = mesh.groups[axis]
    return _in_place(x, lambda t: dist.all_reduce(t, group=group))


def psum_counts(mesh: Mesh, *xs: torch.Tensor) -> None:
    """Sum int32 partial counts over ``grants`` in place — the OR over the
    grant axis, taken on the counts before any threshold (never on packed
    words: no collective has a bitwise OR)."""
    for x in xs:
        if x.dtype != torch.int32:
            raise ConfigError(f"psum_counts takes int32 counts, not {x.dtype}")
        psum(mesh, x, GRANT_AXIS)


def broadcast(mesh: Mesh, x: torch.Tensor, axis: str, member: int) -> torch.Tensor:
    """``x`` of ``axis``'s member ``member`` on every member of the group
    (in place; the others pass a buffer of its shape and dtype)."""
    pod, grant = mesh.coords[POD_AXIS], mesh.coords[GRANT_AXIS]
    src = mesh.global_rank(member, grant) if axis == POD_AXIS else mesh.global_rank(pod, member)
    group = mesh.groups[axis]
    return _in_place(x, lambda t: dist.broadcast(t, src=src, group=group))


def barrier(mesh: Mesh) -> None:
    """Every rank of the mesh's job waits for the others."""
    dist.barrier(group=mesh.groups[BOTH])


def pad_amount(n: int, multiple: int) -> int:
    """Rows to add so ``n`` becomes a (positive) multiple of ``multiple``."""
    if multiple <= 1 or n == 0:
        return 0
    return (multiple - n % multiple) % multiple


def rank_slice(mesh: Mesh, axis: str, total: int) -> slice:
    """This rank's block of an axis of ``total`` rows split evenly over
    ``axis`` (``P(axis)`` of an ``in_specs``)."""
    k = mesh.shape[axis]
    if total % k:
        raise ConfigError(f"{total} rows do not split over {k} {axis} ranks")
    size = total // k
    i = mesh.coords[axis]
    return slice(i * size, (i + 1) * size)
