"""The ('data', 'model') mesh on torch.distributed — the counterpart of
ganreverser_tpu/parallel/mesh.py.

JAX lays a grid of devices out under one program and lets GSPMD insert the
collectives. Here the mesh is a ``torch.distributed`` world of
``data x model`` ranks, one process per rank: rank ``d * model + m`` sits
at data index ``d`` and model index ``m`` (JAX's
``devices.reshape(data, model)``). Each rank belongs to one process group
per axis: its 'data' group holds the ranks of its model index (the axis
that a ``psum`` over 'data' reduces), its 'model' group those of its data
index. There is no global array: a tensor on a rank is that rank's part.

* data-parallel: a batch of n rows is cut over 'data'; the rank at data
  index d holds rows ``mesh.rows(n)`` = [d n / D, (d + 1) n / D), the same
  rows on every rank of its 'model' group (:func:`shard_batch`);
* replicated: the same tensor on every rank (:func:`replicate`);
* 'model'-sharded parameters: a rank stores its slice of each leaf that
  :func:`param_partition_spec` shards and gathers the whole leaf over its
  'model' group before a forward (:class:`ModelShards`), so the axis
  shards memory, not arithmetic (the JAX package leaves that choice to
  XLA; the results are the same).

Without an initialised process group the world is this one process and
every collective is the identity.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from ..core.platform import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P:
    """A partition spec, JAX's ``PartitionSpec``: per dimension of a leaf
    the mesh axis it is cut over, or None (``P()`` is replicated)."""

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __eq__(self, other):
        return isinstance(other, P) and self.axes == other.axes

    def __hash__(self):
        return hash(self.axes)

    def __iter__(self):
        return iter(self.axes)

    def __repr__(self):
        return f"P{self.axes!r}"

    def dim(self, axis_name: str) -> Optional[int]:
        """The dimension cut over ``axis_name``, None when none is."""
        return self.axes.index(axis_name) if axis_name in self.axes else None


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def mesh_shape(data: int, model: int, n: int) -> tuple:
    """(data, model) of a mesh on ``n`` devices, JAX's ``make_mesh`` rules
    and messages: ``data=0`` takes all the devices a model axis leaves; a
    model axis or a mesh larger than the devices is refused."""
    if model < 1:
        model = 1
    if model > n:
        raise ValueError(
            f"model axis {model} exceeds the {n} available devices")
    if data <= 0:
        data = n // model
    if data < 1 or data * model > n:
        raise ValueError(
            f"mesh ({data} data x {model} model) does not fit {n} devices")
    return data, model


class Mesh:
    """This rank's view of the ('data', 'model') mesh: the axis sizes
    (``shape``, as JAX's ``Mesh.shape``), its place, its device and its
    process group along each axis (None without a process group)."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, groups: Optional[dict] = None):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank
        self.device = device
        self.groups = groups or {}

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def axis_index(self, axis_name: str) -> int:
        """This rank's index along ``axis_name``
        (``jax.lax.axis_index``)."""
        d, m = divmod(self.rank, self.shape[MODEL_AXIS])
        return d if axis_name == DATA_AXIS else m

    def axis_ranks(self, axis_name: str) -> list:
        """The global ranks along ``axis_name`` through this rank, in axis
        order."""
        model = self.shape[MODEL_AXIS]
        d, m = divmod(self.rank, model)
        if axis_name == DATA_AXIS:
            return [i * model + m for i in range(self.shape[DATA_AXIS])]
        return [d * model + i for i in range(model)]

    def group(self, axis_name: str):
        return self.groups.get(axis_name)

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of length ``n`` cut over 'data';
        raises unless ``n`` divides evenly."""
        parts = self.shape[DATA_AXIS]
        if n % parts:
            raise ValueError(f"{n} rows do not divide over the data axis of "
                             f"{parts}")
        per = n // parts
        d = self.axis_index(DATA_AXIS)
        return slice(d * per, (d + 1) * per)


def make_mesh(data: int = 0, model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The ('data', 'model') mesh over this process group's world
    (:func:`mesh_shape`'s rules, a rank for a device), with one process
    group per axis line; every rank must call it, as ``new_group`` is
    collective. A mesh smaller than the world is refused as well: a rank
    outside it would have no part. ``device`` defaults to the one this
    rank runs on (``core.platform``)."""
    rank, n = world()
    data, model = mesh_shape(data, model, n)
    if data * model != n:
        raise ValueError(f"mesh ({data} data x {model} model) leaves "
                         f"{n - data * model} of the {n} ranks out")
    groups = {}
    if n > 1 or dist.is_initialized():
        for m in range(model):  # the 'data' lines, one per model index
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                groups[DATA_AXIS] = g
        for d in range(data):   # the 'model' lines, one per data index
            g = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                groups[MODEL_AXIS] = g
    return Mesh(data, model, rank, device or resolve_device(), groups)


# replicated, data_sharding, process_slice and host_local_batch keep JAX's
# API for the layouts and the input share; no path of the port calls them
# (a rank takes its rows with Mesh.rows and shard_batch).

def replicated(mesh: Mesh) -> P:
    return P()


def data_sharding(mesh: Mesh, ndim: int = 1) -> P:
    """Shard the leading (batch / N) axis over 'data'."""
    return P(DATA_AXIS, *([None] * (ndim - 1)))


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the batch ``x`` (:meth:`Mesh.rows`), on its
    device (the 'large-N batch inversion' layout)."""
    return x[mesh.rows(x.shape[0])].to(mesh.device)


def param_partition_spec(leaf, min_size: int = 1 << 16,
                         model_size: int = 1) -> P:
    """Tensor-parallel layout rule: shard the output features of big Dense
    kernels and the output channels of big conv kernels over 'model' (falling
    back to the input dim, then replication, when not divisible); replicate
    everything small (biases, BN, PReLU)."""
    shape = tuple(getattr(leaf, "shape", ()))
    size = math.prod(shape) if shape else 0
    if size < min_size or model_size <= 1:
        return P()
    if len(shape) == 2:
        if shape[1] % model_size == 0:
            return P(None, MODEL_AXIS)
        if shape[0] % model_size == 0:
            return P(MODEL_AXIS, None)
    if len(shape) == 4:
        if shape[3] % model_size == 0:
            return P(None, None, None, MODEL_AXIS)
        if shape[2] % model_size == 0:
            return P(None, None, MODEL_AXIS, None)
    return P()


def shard_leaf(x: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the whole leaf ``x`` under ``spec`` (a copy, on
    the mesh's device)."""
    dim = spec.dim(MODEL_AXIS)
    if dim is not None:
        x = x.chunk(mesh.shape[MODEL_AXIS], dim)[mesh.axis_index(MODEL_AXIS)]
    return x.detach().to(mesh.device, copy=True).contiguous()


def param_specs(tree, mesh: Mesh, min_size: int = 1 << 16):
    """The tree of :func:`param_partition_spec` of each leaf of ``tree``
    (whole leaves)."""
    return pytree.tree_map(
        lambda leaf: param_partition_spec(leaf, min_size,
                                          mesh.shape[MODEL_AXIS]), tree)


def shard_params(tree, mesh: Mesh, min_size: int = 1 << 16):
    """The TP layout rule on a tree of whole tensors: each leaf becomes
    this rank's slice of it (whole when replicated). The 'model' axis of
    size 1 degenerates to full replication. :func:`param_specs` of the
    whole tree is what :func:`~.multihost.gather_replicated` takes back."""
    model_size = mesh.shape[MODEL_AXIS]
    return pytree.tree_map(
        lambda leaf: shard_leaf(
            leaf, param_partition_spec(leaf, min_size, model_size), mesh),
        tree)


def replicate(tree, mesh: Mesh):
    """``tree``'s tensors on the mesh's device, the same on every rank:
    rank 0's values are broadcast over the world."""
    from .comm import broadcast
    return broadcast(pytree.tree_map(
        lambda t: t.to(mesh.device) if isinstance(t, torch.Tensor) else t,
        tree))


def process_slice(n: int, mesh: Optional[Mesh] = None) -> slice:
    """This process's slice of a length-n axis cut over the processes
    (``mesh`` given: over its 'data' axis, :meth:`Mesh.rows`). On a single
    process this is the identity slice."""
    if mesh is not None:
        return mesh.rows(n)
    p, count = world()
    if n % count != 0:
        raise ValueError(
            f"global data size {n} must divide evenly by the process count "
            f"{count} (pad the dataset or adjust the batch)")
    per = n // count
    return slice(p * per, (p + 1) * per)


def host_local_batch(loader, n: int, mesh: Optional[Mesh] = None):
    """Load only this process's share: ``loader(start, count)`` -> array."""
    s = process_slice(n, mesh)
    return loader(s.start, s.stop - s.start)


class ModelShards:
    """The 'model'-axis slices of a module's parameters, the master copy
    of a tensor-parallel train state.

    At creation each parameter is cut by :func:`param_partition_spec`; the
    rank keeps its slices (``local``) and the module's parameters are
    emptied. :meth:`whole` gathers them over the 'model' group into the
    module for the length of a forward and backward, then empties them
    again, so between steps a rank stores only its slices (and the
    optimizer's moments over them). The optimizer updates ``local``."""

    def __init__(self, module: nn.Module, mesh: Mesh,
                 min_size: int = 1 << 16):
        self.module, self.mesh = module, mesh
        self.params = list(module.parameters())
        self.shapes = [tuple(p.shape) for p in self.params]
        self.specs = [param_partition_spec(p, min_size, mesh.shape[MODEL_AXIS])
                      for p in self.params]
        self.local = [shard_leaf(p, s, mesh)
                      for p, s in zip(self.params, self.specs)]
        self._release()

    def slice(self, tensors: list) -> list:
        """This rank's slices of whole tensors aligned with the
        parameters (gradients, moments)."""
        return [shard_leaf(t, s, self.mesh) if s.dim(MODEL_AXIS) is not None
                else t for t, s in zip(tensors, self.specs)]

    def gather(self, tensors: list) -> list:
        """The whole tensors of slices aligned with the parameters (a
        collective over the 'model' group)."""
        from .comm import all_gather
        return [t if s.dim(MODEL_AXIS) is None else
                all_gather(t, self.mesh, MODEL_AXIS, axis=s.dim(MODEL_AXIS))
                for t, s in zip(tensors, self.specs)]

    def _release(self):
        for p in self.params:
            p.data = p.data.new_empty(0)

    @contextlib.contextmanager
    def whole(self):
        """The module with its whole parameters, from the current slices."""
        for p, full in zip(self.params, self.gather(self.local)):
            p.data = full
        try:
            yield self.module
        finally:
            self._release()


def whole_params(*holders):
    """A context in which the module of every holder (a
    :class:`ModelShards`, or a train state with ``shards``) holds its whole
    parameters (:meth:`ModelShards.whole`); None and holders without
    shards are left as they are."""
    stack = contextlib.ExitStack()
    for h in holders:
        shards = h if isinstance(h, ModelShards) else getattr(h, "shards",
                                                              None)
        if shards is not None:
            stack.enter_context(shards.whole())
    return stack
