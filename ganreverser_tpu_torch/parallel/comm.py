"""Collectives on one mesh axis — the counterpart of
ganreverser_tpu/parallel/comm.py.

JAX's collectives name an axis of the mesh the ``shard_map`` runs under;
here each takes this rank's tensor, the :class:`~.mesh.Mesh` and the axis,
and runs on that axis's process group (:meth:`Mesh.group`). Without a
process group they are the identity (one rank holds everything).

The backend is gloo when ranks share a card (parallel/multihost.py), and
gloo reduces and broadcasts CUDA tensors but does not gather or send
them: under gloo, :func:`all_gather` and :func:`ppermute` move CUDA
tensors through host memory and back. :func:`psum` is differentiable:
its backward sums the incoming gradients over the same group, as
``torch.nn.SyncBatchNorm``'s reduction does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import DATA_AXIS, Mesh


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _through_host(x: torch.Tensor) -> bool:
    """Whether a gather or send of ``x`` must go through host memory (gloo
    takes no CUDA tensors there)."""
    return x.is_cuda and dist.get_backend() == "gloo"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """The sum over ``axis_name`` of a tensor, or of each tensor of a tree
    (one reduction per dtype: the leaves are packed into one buffer).
    Differentiable on a single tensor."""
    if not _distributed():
        return x
    group = mesh.group(axis_name)
    if isinstance(x, torch.Tensor):
        return _AllReduceSum.apply(x, group)
    leaves, spec = pytree.tree_flatten(x)
    out = list(leaves)
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i])
    return pytree.tree_unflatten(out, spec)


def pmean(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """The mean over ``axis_name`` (:func:`psum` divided by the axis
    size)."""
    n = mesh.shape[axis_name]
    return pytree.tree_map(lambda t: t / n, psum(x, mesh, axis_name))


def all_gather(x: torch.Tensor, mesh: Mesh, axis_name: str = DATA_AXIS,
               axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` along ``axis_name``, in axis order: concatenated
    along ``axis`` (``tiled``) or stacked in a new ``axis``."""
    if not _distributed():
        return x if tiled else x.unsqueeze(axis)
    host = _through_host(x)
    src = x.detach().cpu() if host else x.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis_name])]
    dist.all_gather(parts, src, group=mesh.group(axis_name))
    out = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
    return out.to(x.device) if host else out


def ppermute(x: torch.Tensor, perm, mesh: Mesh,
             axis_name: str = DATA_AXIS) -> torch.Tensor:
    """``x`` sent along ``axis_name`` by ``perm``, (source, destination)
    pairs of axis indices; a rank that no pair sends to gets zeros."""
    if not _distributed():
        return x.clone() if any(s == d for s, d in perm) else \
            torch.zeros_like(x)
    me, ranks = mesh.axis_index(axis_name), mesh.axis_ranks(axis_name)
    group = mesh.group(axis_name)
    host = _through_host(x)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    out = torch.zeros_like(src)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(src)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, ranks[d], group))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if host else out


def broadcast(tree, src: int = 0):
    """Every tensor of ``tree`` set to global rank ``src``'s values, over
    the world (one broadcast per dtype and device)."""
    if not _distributed():
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        if isinstance(t, torch.Tensor):
            by_dtype.setdefault((t.dtype, t.device), []).append(i)
    out = list(leaves)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view_as(leaves[i]).clone()
    return pytree.tree_unflatten(out, spec)


def sharded_topk_merge(scores: torch.Tensor, k: int, mesh: Mesh,
                       axis_name: str = DATA_AXIS):
    """The global top-k of a score vector cut over ``axis_name``: a local
    top-k per rank, its (value, global index) candidates all-gathered, a
    final top-k — the collective replacement for the reference's host-side
    full sorts (apply_r.lua:275, sample.lua:130-148).

    scores: this rank's (local_n,) part, every rank the same length.
    Returns (values, global_indices), the same on every rank."""
    local_n = scores.shape[0]
    v, i = torch.topk(scores, min(k, local_n))
    gi = i + mesh.axis_index(axis_name) * local_n
    v_all = all_gather(v, mesh, axis_name)
    gi_all = all_gather(gi, mesh, axis_name)
    fv, fi = torch.topk(v_all, k)
    return fv, gi_all[fi]
