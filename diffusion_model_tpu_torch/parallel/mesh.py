"""Process meshes and batch layouts for data-parallel training and
node-sharded generation, as ``diffusion_model_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over its devices and lets
GSPMD insert the collectives. PyTorch has neither virtual devices nor a
compiler that inserts collectives, so here the mesh is a grid of the ranks
of an initialised ``torch.distributed`` world, with one process group for
each line of ranks along an axis and one for the whole mesh; a rank holds
its own slice of every sharded tensor and calls the collectives itself
(``Trainer.train_step(..., mesh=)`` sums the gradients, ``parallel.ring``
rotates blocks).

Strategies (the JAX module's):
  * DP: the graph-batch axis over ``data`` (over every axis of a hybrid
    ``("replica", "data")`` mesh); parameters replicated, gradients summed.
  * node sharding: the node axis of ``[B, N, ...]`` over ``data``, the
    layout of ``parallel.ring``.
  * ``dp_node`` (hybrid mesh only): graphs over ``replica``, nodes over
    ``data``.

``dp_batch_sharding``, ``node_sharding`` and ``replicate`` return a
``Layout``, the counterpart of a ``NamedSharding``: which axes each
dimension is split over, and so which block this rank holds.
``shard_graph_batch`` returns this rank's block of a ``GraphBatch``.

A world is started by ``launch(fn, world_size)`` (one process a rank,
``torch.multiprocessing.spawn`` over a ``FileStore``: the port's
counterpart of the JAX tests' 8-device virtual CPU mesh) or, for one rank
in this process, by ``init_single(backend)`` (a ``HashStore``: no port, no
network; how the card runs it with NCCL).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffusion_model_tpu_torch.data.batch import GraphBatch

NO_WORLD = (
    "needs an initialised torch.distributed process group: start one with "
    "parallel.launch(fn, world_size) (one process a rank) or, for one rank "
    "in this process, parallel.init_single(\"gloo\" | \"nccl\")")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The global ranks laid out as ``ranks`` (an array of the mesh's shape)
    with ``axis_names``. ``coords`` is this rank's position (None where the
    rank lies outside the mesh); ``lines[axis]`` the process group and the
    ranks of this rank's line along ``axis``; ``group`` the whole mesh's."""

    ranks: np.ndarray
    axis_names: tuple
    coords: Optional[tuple]
    lines: dict
    group: object

    @property
    def shape(self) -> tuple:
        return tuple(self.ranks.shape)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        return self.coords[self.axis_names.index(axis)]

    def group_over(self, axes: Sequence[str]):
        """(process group, its ranks in order) of this rank's ranks that
        differ only along ``axes``: one axis, or all of them."""
        axes = tuple(axes)
        if set(axes) == set(self.axis_names):
            return self.group, [int(r) for r in self.ranks.reshape(-1)]
        if len(axes) == 1:
            return self.lines[axes[0]]
        raise ValueError(f"no group over {axes} of mesh axes "
                         f"{self.axis_names}")


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} {NO_WORLD}")
    return dist.get_world_size()


def _group(ranks: list):
    """A process group over ``ranks``; the world's own where they are the
    whole world. Every rank of the world must call this, in one order."""
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks=ranks)


def _build(arr: np.ndarray, axis_names: tuple) -> Mesh:
    me = dist.get_rank()
    where = np.argwhere(arr == me)
    coords = tuple(int(c) for c in where[0]) if len(where) else None
    lines = {}
    for a, name in enumerate(axis_names):
        moved = np.moveaxis(arr, a, -1).reshape(-1, arr.shape[a])
        for line in moved:
            ranks = [int(r) for r in line]
            group = _group(ranks)
            if me in ranks:
                lines[name] = (group, ranks)
    whole = _group([int(r) for r in arr.reshape(-1)])
    return Mesh(arr, tuple(axis_names), coords, lines, whole)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh of ``shape`` over the first ranks of the world (default every
    rank on one ``data`` axis), as the JAX ``make_mesh`` lays the visible
    devices out. Every rank of the world calls it (it creates the process
    groups)."""
    world = _world("make_mesh")
    if shape is None or len(shape) == 0:
        shape = (world,)
    count = int(np.prod(shape))
    if count > world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {count} "
                         f"ranks; the world has {world}")
    arr = np.arange(count).reshape(tuple(shape))
    return _build(arr, tuple(axis_names[: arr.ndim]))


def make_hybrid_mesh(dcn_replicas: int, ici_size: Optional[int] = None,
                     axis_names: Sequence[str] = ("replica", "data")) -> Mesh:
    """The two-level ``("replica", "data")`` mesh: ``dcn_replicas`` rows of
    ``ici_size`` ranks (default the world over the rows), a process group
    for each row and each column. The JAX package keeps a row inside one
    TPU slice; here a row is ``ici_size`` consecutive ranks, so with one
    host's ranks numbered together a row's collectives stay on the host."""
    world = _world("make_hybrid_mesh")
    if ici_size is None:
        ici_size = world // dcn_replicas
    if dcn_replicas * ici_size > world:
        raise ValueError(f"a {dcn_replicas} x {ici_size} mesh needs more "
                         f"ranks than the world's {world}")
    arr = np.arange(dcn_replicas * ici_size).reshape(dcn_replicas, ici_size)
    return _build(arr, tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Layout:
    """A ``NamedSharding`` as a description: ``spec[d]`` is None (dimension
    ``d`` replicated), an axis name or a tuple of axis names (split over
    them, the first the major), as ``PartitionSpec``; dimensions past the
    spec are replicated."""

    mesh: Mesh
    spec: tuple

    def axes(self, dim: int) -> tuple:
        entry = self.spec[dim] if dim < len(self.spec) else None
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def block(self, dim: int, size: int) -> slice:
        """This rank's slice of a dimension of ``size`` along ``dim``: block
        ``i`` of ``k`` equal blocks, ``i`` the row-major index of this
        rank's coordinates over the dimension's axes."""
        index, count = 0, 1
        for axis in self.axes(dim):
            index = index * self.mesh.axis_size(axis) \
                + self.mesh.axis_index(axis)
            count *= self.mesh.axis_size(axis)
        if size % count:
            raise ValueError(f"dimension {dim} of size {size} does not split "
                             f"into {count} blocks over {self.axes(dim)}")
        width = size // count
        return slice(index * width, (index + 1) * width)

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``tensor`` (a view)."""
        index = tuple(self.block(d, tensor.shape[d])
                      for d in range(min(len(self.spec), tensor.ndim)))
        return tensor[index]


def dp_batch_sharding(mesh: Mesh, axis: str = "data") -> Layout:
    """The leading (batch) axis split over ``axis``; over every axis of the
    hierarchical ``("replica", "data")`` mesh, and of any other mesh of
    several axes that lacks ``axis`` (a hybrid mesh under other names); a
    second axis of another mesh stays replicated."""
    names = mesh.axis_names
    if set(names) == {"replica", "data"}:
        return Layout(mesh, (tuple(names),))
    if axis in names:
        return Layout(mesh, (axis,))
    if len(names) > 1:
        return Layout(mesh, (tuple(names),))
    raise ValueError(f"axis {axis!r} not in mesh axes {names}")


def node_sharding(mesh: Mesh, axis: str = "data") -> Layout:
    """The node axis (dimension 1 of ``[B, N, ...]``) split: the large-cell
    layout."""
    return Layout(mesh, (None, axis))


def replicate(mesh: Mesh) -> Layout:
    return Layout(mesh, ())


def shard_graph_batch(batch: GraphBatch, mesh: Mesh, mode: str = "dp",
                      axis: str = "data") -> GraphBatch:
    """This rank's block of ``batch``.

    mode='dp':      the batch axis split (training, batched generation);
                    over every mesh axis on a hierarchical mesh.
    mode='node':    the node axis split (one huge graph).
    mode='dp_node': hierarchical mesh only: graphs over 'replica', nodes
                    over 'data'.
    """
    if mode == "dp":
        layout = dp_batch_sharding(mesh, axis)
    elif mode == "node":
        layout = node_sharding(mesh, axis)
    elif mode == "dp_node":
        if "replica" not in mesh.axis_names:
            raise ValueError("dp_node needs a ('replica', 'data') mesh "
                             "(make_hybrid_mesh)")
        layout = Layout(mesh, ("replica", axis))
    else:
        raise ValueError(mode)
    return batch.map(layout.local)


def init_single(backend: str) -> None:
    """A world of one rank in this process over a ``HashStore`` (no port, no
    network): ``"nccl"`` on the card, ``"gloo"`` on the CPU."""
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _entry(rank: int, fn: Callable, world_size: int, backend: str,
           store_path: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, backend: str = "gloo",
           store_path: Optional[str] = None, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes joined in one
    ``torch.distributed`` world (``backend``; the ranks meet through a
    ``FileStore`` at ``store_path``, a new temporary file by default), each
    with one intra-op thread (the ranks share the host's cores); returns
    when every rank has, and raises where one failed. ``fn`` must be
    importable (a module's top-level function): the processes are
    spawned."""
    own = store_path is None
    if own:
        fd, store_path = tempfile.mkstemp(prefix="torch_store_")
        os.close(fd)
        os.unlink(store_path)
    try:
        torch.multiprocessing.spawn(
            _entry, args=(fn, world_size, backend, store_path, tuple(args)),
            nprocs=world_size, join=True)
    finally:
        if own and os.path.exists(store_path):
            os.unlink(store_path)
