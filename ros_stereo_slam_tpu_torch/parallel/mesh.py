"""A one-dimensional mesh of ranks over ``torch.distributed``.

Port of ``ros_stereo_slam_tpu/parallel/mesh.py``.  The JAX package lays
one mesh axis ("shard") over its devices and writes the sharded solvers
with ``shard_map``; here every rank of a process group is one shard, each
running the same program on its own device (SPMD), and the collectives
that ``shard_map`` gives the JAX code are the plain functions below.

The default group is initialised by the caller (``torchrun``, or
``init_process_group`` with an explicit store, rank and world size):
:func:`make_mesh` only reads it.  A group has one axis, so the JAX
package's ``axis_name`` and ``lax.axis_index`` become the mesh itself and
``mesh.rank``.  On the card the group must be NCCL's, one GPU per rank;
on the CPU (tests, the dry run) gloo's.  Nothing falls back from one to
the other: a mismatch raises.

``COLLECTIVES`` counts the calls each collective made (a ``ppermute`` at
world size 1 makes none), as the kernel wrappers count launches.
"""

from __future__ import annotations

import math
import os
from collections import Counter
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ros_stereo_slam_tpu_torch.config import ParallelConfig

COLLECTIVES: Counter = Counter()  # calls per collective ("all_reduce", ...)


@dataclass(frozen=True)
class Mesh:
    """The ranks of the default process group along one axis (the JAX
    mesh's "shard" axis): this rank, their number, this rank's device."""

    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: int | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh of the initialised default process group.

    `device` defaults to ``cuda:<local rank>`` (``LOCAL_RANK`` as torchrun
    sets it, else the rank) and needs an NCCL group; a CPU device needs a
    gloo group.  `n_devices`, if given, must be the group's size.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked of a group of {size}")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    want = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    backend = dist.get_backend()  # e.g. "nccl", or "cpu:gloo,cuda:nccl"
    if want is None or want not in backend:
        raise RuntimeError(f"a mesh on {device} needs a {want} group, this one is {backend}")
    return Mesh(rank=rank, size=size, device=device)


def mesh_from_config(cfg: ParallelConfig, device: torch.device | str | None = None) -> Mesh:
    """:func:`make_mesh` of ``cfg.mesh_shape``'s ranks (config 5's layout)."""
    return make_mesh(math.prod(cfg.mesh_shape), device)


def check_mesh(mesh) -> None:
    """Raise TypeError unless `mesh` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, on every rank (a new tensor).  Every
    rank reaches every call, in the same order; at world size 1 the sum of
    one term is `x` itself, bit for bit."""
    y = x.clone(memory_format=torch.contiguous_format)
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(y)
    return y


def psum_many(mesh: Mesh, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """:func:`psum` of tensors of one dtype in one all-reduce."""
    flat = psum(torch.cat([x.reshape(-1) for x in xs]), mesh)
    return tuple(p.view(x.shape) for p, x in
                 zip(flat.split([x.numel() for x in xs]), xs, strict=True))


def ppermute(x: torch.Tensor, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank d sends `x` to rank d + shift and returns what rank
    d - shift sent (both modulo the size).  At world size 1 it is `x`, with
    no call."""
    if mesh.size == 1:
        return x
    send = x.contiguous()
    recv = torch.empty_like(send)
    COLLECTIVES["ppermute"] += 1
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + shift) % mesh.size),
           dist.P2POp(dist.irecv, recv, (mesh.rank - shift) % mesh.size)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` concatenated along axis 0 in rank order (a leading-
    axis shard made whole).  bool travels as uint8."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, wire)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank got here (an all-reduce, so NCCL needs no
    device guess)."""
    psum(torch.zeros(1, device=mesh.device), mesh).item()


def shard_bounds(n: int, mesh: Mesh, what: str = "axis") -> slice:
    """This rank's block of a leading axis of length `n`; raises when `n`
    does not divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"{what} of {n} not divisible by the mesh size {mesh.size}")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)
