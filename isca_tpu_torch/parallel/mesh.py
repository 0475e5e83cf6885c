"""Process meshes for the sharded spectral GCM.

Port of isca_tpu/parallel/mesh.py (reference: the MPI domain decomposition
of src/atmos_spectral/tools/spec_mpp.F90) as an explicit SPMD design on
torch.distributed: one process (rank) per device, each holding its own
block of every array and running the same program on it.

* Grid space is sharded over latitude bands: the physics is column-local,
  so it needs no halo (the finite-volume tracer advection exchanges two
  rows with its neighbours, `Mesh.exchange_rows`).
* Spectral space is sharded over zonal wavenumber m.
* The transforms re-partition between the two layouts with one
  `all_to_all` each (isca_tpu_torch.spectral.transforms), and every global
  mean is an `all_reduce`.

isca_tpu gets the same from shard_map and GSPMD in one process. A rank's
block of an axis of extent E on a mesh of n ranks is the contiguous rows
[rank * E/n, (rank + 1) * E/n), in rank order.

`spawn` starts the ranks of one machine (the tests, chip_smoke.py); the
backend ("gloo" or "nccl") is always named by the caller.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from isca_tpu_torch.utils.tree import flatten_with_paths, unflatten

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a 1-D mesh: its process group, its place in it and
    the device its blocks live on."""

    group: Any            # torch.distributed process group (None: the default group)
    rank: int
    size: int
    backend: str          # "gloo" | "nccl"
    device: torch.device

    def block(self, extent: int) -> tuple[int, int]:
        """This rank's [start, stop) of an axis of `extent` rows."""
        if extent % self.size:
            raise ValueError(f"an axis of {extent} rows does not split over "
                             f"{self.size} ranks")
        b = extent // self.size
        return self.rank * b, (self.rank + 1) * b

    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """Send block r of x's leading axis (size * c rows) to rank r and
        receive rank r's block for this rank in its place: (out, work), work
        None unless async_op (then wait on it before reading out)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group, async_op=async_op)
        return out, work

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise sum (or "min", "max") of x over the ranks, out of
        place; every rank gets the same value."""
        out = x.detach().clone().contiguous()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out

    def all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The ranks' x (one shape) joined along `axis` in rank order."""
        real = torch.view_as_real(x) if x.is_complex() else x
        real = real.contiguous()
        parts = [torch.empty_like(real) for _ in range(self.size)]
        dist.all_gather(parts, real, group=self.group)
        out = torch.cat(parts, dim=axis % x.ndim)
        return torch.view_as_complex(out) if x.is_complex() else out

    def exchange_rows(self, x: torch.Tensor, width: int):
        """Latitude halo rows from the neighbouring bands.

        x is (..., lat, lon). Returns (south, north): the `width` rows just
        south of this band (the top rows of rank - 1) and just north of it
        (the bottom rows of rank + 1), each (..., width, lon), or None at
        the mesh's ends. One all_to_all that moves rows between neighbours
        only."""
        rows = x.movedim(-2, 0)
        send, split_in, split_out = [], [0] * self.size, [0] * self.size
        if self.rank > 0:
            send.append(rows[:width])
            split_in[self.rank - 1] = split_out[self.rank - 1] = width
        if self.rank < self.size - 1:
            send.append(rows[-width:])
            split_in[self.rank + 1] = split_out[self.rank + 1] = width
        inp = (torch.cat(send, dim=0) if send else rows[:0]).contiguous()
        out = torch.empty((sum(split_out),) + tuple(rows.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_to_all_single(out, inp, split_out, split_in, group=self.group)
        back = lambda r: r.movedim(0, -2)
        south = back(out[:width]) if self.rank > 0 else None
        north = back(out[-width:]) if self.rank < self.size - 1 else None
        return south, north


def make_mesh(n_devices: int | None = None, group=None, device=None) -> Mesh:
    """The 1-D mesh over the ranks of an initialised process group.

    n_devices, when given, must be the group's size: asking for more ranks
    than exist is an error, never a silent truncation (a mesh of 1 exercises
    no sharding, so a run that "passed" on it would be a false green), and a
    mesh spans its whole group (pass a group of n ranks for fewer).
    device: None places rank r's blocks on cuda:{r % device_count} (and
    raises without CUDA); "cpu" on the CPU, as the tests run.
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or spawn)")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"make_mesh(n_devices={n_devices}) but the process group has {size} "
            f"rank(s): start {n_devices} ranks (spawn(..., nprocs={n_devices})) or "
            "pass a group of that size")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh places blocks on CUDA by default and no "
                               "CUDA device is available; pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group=group, rank=rank, size=size, backend=dist.get_backend(group),
                device=device)


def check_mesh(mesh) -> Mesh:
    """mesh itself, or TypeError when it is not a Mesh."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be an isca_tpu_torch.parallel.mesh.Mesh "
                        f"(make_mesh), not {type(mesh).__name__}")
    return mesh


def _first_lat_axis(shape, nlat: int) -> int | None:
    """Axis -2 when it has nlat rows (level-first (..., lat, lon)), else the
    leftmost such axis (level-last caches (lat, lon, L))."""
    ndim = len(shape)
    for ax in [ndim - 2] + [a for a in range(ndim) if a != ndim - 2]:
        if shape[ax] == nlat:
            return ax
    return None


def shard_axis(size: int, x: torch.Tensor, nlat: int | None = None) -> int | None:
    """The axis a GLOBAL leaf shards on (isca_tpu's _spec_for), or None
    (replicated):

    * complex leaves of 2 or more dims: m (axis -2) when it divides;
    * real leaves with the `nlat` hint: their first latitude axis (axis -2
      preferred) when nlat divides;
    * other real leaves of 2 or more dims: axis -2 when it divides.
    """
    if x.ndim < 2:
        return None
    if x.is_complex():
        return x.ndim - 2 if x.shape[-2] % size == 0 else None
    if nlat is not None:
        return _first_lat_axis(x.shape, nlat) if nlat % size == 0 else None
    return x.ndim - 2 if x.shape[-2] % size == 0 else None


def local_axis(size: int, x: torch.Tensor, nlat: int | None = None) -> int | None:
    """The axis a rank's LOCAL block `x` was sharded on by shard_pytree, read
    from its own shape by the same rules (a latitude axis has nlat/size
    rows). A leaf that shard_pytree replicated because its axis did not
    divide cannot be told apart from a block here: the mesh's transforms pad
    m to the mesh size, so a model state holds no such leaf."""
    if x.ndim < 2:
        return None
    if x.is_complex():
        return x.ndim - 2
    if nlat is not None:
        return _first_lat_axis(x.shape, nlat // size) if nlat % size == 0 else None
    return x.ndim - 2


class Sharding:
    """How one leaf is laid out over the mesh: its sharded axis (None when
    replicated), its global shape, and each rank's [start, stop) of the
    axis. A plain class, so that a tree of them is a leaf per leaf for
    utils.tree as a tree of NamedShardings is for jax.tree_util."""

    __slots__ = ("axis", "shape", "blocks")

    def __init__(self, axis: int | None, shape: tuple, blocks: list):
        self.axis, self.shape, self.blocks = axis, tuple(shape), list(blocks)

    def __eq__(self, other):
        return isinstance(other, Sharding) and (
            (self.axis, self.shape, self.blocks) == (other.axis, other.shape, other.blocks))

    def __repr__(self):
        return f"Sharding(axis={self.axis}, shape={self.shape}, blocks={self.blocks})"


def _leaf_sharding(size, axis, shape) -> Sharding:
    if axis is None:
        return Sharding(None, tuple(shape), [])
    b = shape[axis] // size
    return Sharding(axis, tuple(shape), [(r * b, (r + 1) * b) for r in range(size)])


def shard_pytree(mesh: Mesh, tree, nlat: int | None = None):
    """This rank's contiguous block of each tensor leaf of a global tree
    (shard_axis chooses the axis); replicated leaves and non-tensor leaves
    pass through. Each block keeps its leaf's device and owns its memory."""
    out = []
    for _, leaf in flatten_with_paths(tree):
        axis = shard_axis(mesh.size, leaf, nlat) if torch.is_tensor(leaf) else None
        if axis is not None:
            start, stop = mesh.block(leaf.shape[axis])
            leaf = leaf.narrow(axis, start, stop - start).clone()
        out.append(leaf)
    return unflatten(tree, out)


def sharding_pytree(mesh: Mesh, tree, nlat: int | None = None):
    """For each tensor leaf of a GLOBAL tree, its Sharding: the axis and the
    global [start, stop) of every rank's block (None for non-tensor leaves)."""
    return unflatten(tree, [
        _leaf_sharding(mesh.size, shard_axis(mesh.size, leaf, nlat), leaf.shape)
        if torch.is_tensor(leaf) else None
        for _, leaf in flatten_with_paths(tree)])


def local_sharding(mesh: Mesh, leaf: torch.Tensor, nlat: int | None = None) -> Sharding:
    """The Sharding of a LOCAL block (local_axis): the global shape is the
    block's with the sharded axis times the mesh size."""
    axis = local_axis(mesh.size, leaf, nlat)
    shape = list(leaf.shape)
    if axis is not None:
        shape[axis] *= mesh.size
    return _leaf_sharding(mesh.size, axis, shape)


def gather_pytree(mesh: Mesh, tree, nlat: int | None = None):
    """The global tree from every rank's blocks (all_gather along each
    leaf's local_axis), on every rank; replicated leaves pass through."""
    out = []
    for _, leaf in flatten_with_paths(tree):
        axis = local_axis(mesh.size, leaf, nlat) if torch.is_tensor(leaf) else None
        out.append(leaf if axis is None else mesh.all_gather(leaf, axis))
    return unflatten(tree, out)


def _rank_main(rank, fn, nprocs, backend, init_file, args, threads, timeout_s):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method="file://" + init_file, rank=rank,
                            world_size=nprocs,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, backend: str, init_file: str, args: tuple = (),
          threads: int | None = None, timeout_s: float = 600.0, join: bool = True):
    """Run fn(rank, *args) in `nprocs` new processes joined in one process
    group over `backend` ("gloo" or "nccl"), met through `init_file` (a path
    that does not exist yet; no ports are opened). threads: torch threads
    per rank. A rank that raises fails the call, and the others are stopped.
    join=False returns the torch.multiprocessing context to join later."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    init_file = os.path.abspath(init_file)
    if os.path.exists(init_file):
        raise ValueError(f"spawn's init_file {init_file} exists already")
    return torch.multiprocessing.spawn(
        _rank_main, args=(fn, nprocs, backend, init_file, tuple(args), threads, timeout_s),
        nprocs=nprocs, join=join)
