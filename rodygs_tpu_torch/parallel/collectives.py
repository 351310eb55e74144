"""The `lax` collectives the JAX package's multi-device code uses, on
`torch.distributed` over a mesh `Axis` (parallel/mesh.py).

  * `all_gather(x, axis, dim)` — JAX's tiled `all_gather`: the axis's
    blocks concatenated along `dim` in axis order. Differentiable: its
    backward is `reduce_scatter_tensor` (sum), JAX's `psum_scatter`, which
    hands each rank the summed cotangent of exactly its own block.
  * `psum` / `pmean` / `pmax` over an axis, of a tensor or of a tree of
    tensors (one collective for the whole tree, per dtype).
  * `axis_index` / `axis_size`.

An axis of size 1 makes every collective the identity.

Backends. The caller states the backend (mesh.py); nothing here picks
one. NCCL serves ranks that each have their own card. Gloo serves the CPU,
and ranks that share one card (NCCL refuses two ranks on one GPU).

NCCL, as this module uses it (run across four H100s over NVLink, torch
2.11.0+cu128): `all_reduce` (sum, max; float32, float64, int32),
`all_gather_into_tensor` and `reduce_scatter_tensor`. NCCL requires of
them what the code here provides: every rank's input the same size,
contiguous and on the rank's own (current) card, the output allocated
contiguous at size times the input; bool tensors go as uint8 (neither
backend has bool). The calls are synchronous: the caller's stream waits
for NCCL's, so a host read of a reduced value (`bool(overflow)` of the
sharded step's fragment counts) sees the reduced value. Every rank must
issue the same collectives in the same order on the same groups: NCCL
waits for a missing peer instead of raising, until the process group's
timeout (multihost.DEFAULT_TIMEOUT_S, `run_world`'s deadline). The object
collectives of multihost.py and the trainers (`all_gather_object`,
`broadcast_object_list`) run on the current card under NCCL, which is
why the mesh sets each rank's card before any of them.

Gloo and CUDA tensors, measured on an H100 (torch 2.11.0+cu128, two ranks
on one card): `all_reduce` (sum, max), `broadcast`,
`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_gather` and
`barrier` take CUDA tensors and give the right values; point-to-point
`send` / `recv` fail on CUDA tensors ("Bad address"). This module uses
only the first kind, so no op is staged through host memory here: Gloo
copies through the host inside its CUDA paths. Should an op Gloo refuses
on CUDA tensors be needed, it is staged here, by rule and per op.

Every tensor must lie on the mesh's device type: a CPU tensor on a CUDA
mesh raises, and so does a CUDA tensor on a CPU mesh.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis

# the single-tensor all-gather and reduce-scatter: torch 2.13 renames
# all_gather_into_tensor / reduce_scatter_tensor (same arguments) and
# deprecates the old names, which older torch releases alone have
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def axis_size(axis: Axis) -> int:
    return axis.size


def axis_index(axis: Axis) -> int:
    return axis.index


def _check(x: torch.Tensor, axis: Axis) -> None:
    if x.device.type != axis.device.type:
        raise ValueError(
            f"collective over {axis.names} on a {axis.device.type} mesh got a "
            f"{x.device.type} tensor")


def _all_reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    """All-reduce of a copy of x (x itself is left as it is)."""
    out = x.clone()
    dist.all_reduce(out, op=op, group=axis.group)
    return out


def _gather_dim0(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    cast = x.dtype == torch.bool   # Gloo has no bool: gather as uint8
    src = x.to(torch.uint8) if cast else x
    out = torch.empty((axis.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=src.dtype, device=x.device)
    _ALL_GATHER(out, src, group=axis.group)
    return out.to(torch.bool) if cast else out


class _AllGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_dim0(x.movedim(dim, 0), axis).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        g0 = g.movedim(dim, 0).contiguous()
        out = torch.empty((g0.shape[0] // axis.size,) + tuple(g0.shape[1:]),
                          dtype=g0.dtype, device=g0.device)
        _REDUCE_SCATTER(out, g0, group=axis.group)
        return out.movedim(0, dim), None, None


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The axis's blocks of x concatenated along `dim` in axis order;
    differentiable (backward: reduce-scatter, sum)."""
    _check(x, axis)
    if axis.size == 1:
        return x
    dim = dim % x.dim()
    if x.requires_grad:
        return _AllGather.apply(x, axis, dim)
    return _gather_dim0(x.movedim(dim, 0), axis).movedim(0, dim)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    kids = [_rebuild(v, it) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def _reduce_tree(tree, axis: Axis, op):
    """One all-reduce per dtype over the flattened leaves of `tree`."""
    leaves = _leaves(tree)
    for x in leaves:
        _check(x, axis)
    if axis.size == 1:
        return tree
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat, axis, op)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return _rebuild(tree, iter(out))


def psum(tree, axis: Axis):
    """Sum over the axis of a tensor or a tree (tuple, NamedTuple, list,
    dict) of tensors."""
    return _reduce_tree(tree, axis, dist.ReduceOp.SUM)


def pmean(tree, axis: Axis):
    summed = psum(tree, axis)
    if axis.size == 1:
        return summed
    return _rebuild(summed, iter([x / axis.size for x in _leaves(summed)]))


def pmax(tree, axis: Axis):
    return _reduce_tree(tree, axis, dist.ReduceOp.MAX)


def all_gather_rows(tree, axis: Axis):
    """Every leaf of `tree` (tensors whose leading dimension is this rank's
    rows) gathered along that dimension in axis order, not differentiable:
    one gather per dtype, the leaves packed side by side."""
    leaves = _leaves(tree)
    for x in leaves:
        _check(x, axis)
    if axis.size == 1:
        return tree
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        cols = [leaves[i].reshape(leaves[i].shape[0], -1) for i in idx]
        full = _gather_dim0(torch.cat(cols, dim=1), axis)
        for i, part in zip(idx, full.split([c.shape[1] for c in cols], 1)):
            out[i] = part.reshape((-1,) + tuple(leaves[i].shape[1:]))
    return _rebuild(tree, iter(out))
