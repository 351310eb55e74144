"""Adaptive density control on the fixed-capacity store: statistics, clone,
split, prune and the opacity reset. Port of `rodygs_tpu/train/densify.py`.

The capacity never changes: freed slots (dead, pruned and split parents)
are ranked by a cumsum, new Gaussians scatter into them, and the Adam
moments of new slots are zeroed by the same masks. Requests past the free
slots are dropped and counted in `DensifyInfo.dropped`. The JAX package
writes with `.at[dest].set(..., mode="drop")`, `dest == C` meaning
"nowhere"; here every scatter goes into a C+1 buffer whose last row takes
those writes and is cut off.

Both reference quirks of the JAX package are kept with their opt-ins: the
screen-radius prune reads `max_radii2D` after the reference zeroed it, so
it never fires unless `apply_screen_size_prune`; and the reference's
append-then-prune is applied analytically (an appended clone or child
survives iff its inherited opacity and world size pass the prune).

The split samples come from `split_noise`, the one random draw here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.gaussians import (GaussianStore, get_opacity, get_scaling,
                                inverse_sigmoid)
from ..ops.quaternion import quat_normalize, quat_to_matrix
from ..utils.platform import resolve_device
from ..utils.profiling import host_read, span
from .optim import tree_map


class DensifyStats(NamedTuple):
    """Accumulated screen-space gradient statistics."""

    grad_accum: torch.Tensor   # [C]
    denom: torch.Tensor        # [C]
    max_radii2d: torch.Tensor  # [C] float (pixel radii)


class DensifyInfo(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    dropped: torch.Tensor   # new Gaussians that did not fit in capacity


def init_stats(capacity: int, device=None) -> DensifyStats:
    z = torch.zeros((capacity,), dtype=torch.float32,
                    device=resolve_device(device))
    return DensifyStats(grad_accum=z, denom=z.clone(), max_radii2d=z.clone())


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, means2d_grad: torch.Tensor,
                     radii: torch.Tensor, visible: torch.Tensor) -> DensifyStats:
    """Per-step update; `means2d_grad` is [2, C] in scaled-NDC units."""
    gnorm = torch.sqrt(means2d_grad[0] ** 2 + means2d_grad[1] ** 2)
    vis = visible.to(torch.float32)
    return DensifyStats(
        grad_accum=stats.grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(visible, radii, 0.0)),
    )


def split_noise(generator: torch.Generator, capacity: int, device):
    """The two standard-normal [C, 3] samples of the split children."""
    return tuple(torch.randn((capacity, 3), generator=generator, device=device)
                 for _ in range(2))


def _rank_free_slots(free_mask: torch.Tensor) -> torch.Tensor:
    """slot_of_rank[r] = index of the r-th free slot (C where none)."""
    c = free_mask.shape[0]
    ranks = torch.where(free_mask, torch.cumsum(free_mask.long(), 0) - 1, c)
    slot_of_rank = torch.full((c + 1,), c, dtype=torch.long,
                              device=free_mask.device)
    slot_of_rank[ranks] = torch.arange(c, device=free_mask.device)
    return slot_of_rank[:c]


@torch.no_grad()
@span("densify_and_prune")
def densify_and_prune(
    store: GaussianStore,
    aux: dict[str, Any],
    stats: DensifyStats,
    generator: torch.Generator,
    max_grad: float,
    min_opacity: float,
    extent: float,
    percent_dense: float,
    max_screen_size: float | None,
    isotropic: bool = False,
    apply_screen_size_prune: bool = False,
) -> tuple[GaussianStore, dict[str, Any], DensifyStats, DensifyInfo]:
    """One densification pass.

    `aux` maps names to trees (NamedTuples, dicts or tensors) of extra
    per-Gaussian tensors with leading dim C that follow slot moves: the
    Adam moments of every param leaf and, for the dynamic model,
    `motion_coeff` and its moments. New slots take copies from their
    source, except that every leaf of an `aux` entry whose name starts with
    'mu_' / 'nu_' is zeroed there (Adam surgery)."""
    p = store.params
    c = p.xyz.shape[0]
    dev = p.xyz.device
    alive = store.alive

    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, 0.0)
    scaling = get_scaling(p, isotropic)
    max_scale = torch.max(scaling, dim=1).values
    opacity = get_opacity(p)

    high_grad = (grads >= max_grad) & alive
    clone_src = high_grad & (max_scale <= percent_dense * extent)
    split_src = high_grad & (max_scale > percent_dense * extent)
    n_split_children = 2

    survives = ~(opacity < min_opacity)
    if max_screen_size is not None:
        child_max_scale = max_scale / (0.8 * n_split_children)
        clone_mask = clone_src & survives & ~(max_scale > 0.1 * extent)
        place_mask = split_src & survives & ~(child_max_scale > 0.1 * extent)
    else:
        clone_mask = clone_src & survives
        place_mask = split_src & survives

    prune_mask = (opacity < min_opacity) & alive
    if max_screen_size is not None:
        prune_mask = prune_mask | (alive & (max_scale > 0.1 * extent))
        if apply_screen_size_prune:
            prune_mask = prune_mask | (
                alive & (stats.max_radii2d > max_screen_size))

    # a split always frees its parent slot, placed children or not
    keep_mask = alive & ~prune_mask & ~split_src
    free_mask = ~keep_mask
    slot_of_rank = _rank_free_slots(free_mask)
    num_free = torch.sum(free_mask.long())

    n_clone = torch.sum(clone_mask.long())
    # ranks: clones first, then 2 children per placed split
    clone_rank = torch.where(clone_mask, torch.cumsum(clone_mask.long(), 0) - 1, c)
    split_base = n_clone + 2 * (torch.cumsum(place_mask.long(), 0) - 1)
    split_rank0 = torch.where(place_mask, split_base, c)
    split_rank1 = torch.where(place_mask, split_base + 1, c)

    def dest(rank):
        return torch.where(rank < num_free,
                           slot_of_rank[torch.clamp(rank, 0, c - 1)], c)

    # one scatter for all three kinds: the ranks are distinct, so the
    # destinations below C are too; C is the discarded row
    dests = torch.cat([dest(clone_rank), dest(split_rank0), dest(split_rank1)])

    rot = quat_to_matrix(quat_normalize(p.rotation))
    n0, n1 = split_noise(generator, c, dev)
    child_xyz0 = p.xyz + torch.einsum("nij,nj->ni", rot, n0 * scaling)
    child_xyz1 = p.xyz + torch.einsum("nij,nj->ni", rot, n1 * scaling)
    child_scaling = torch.log(scaling / (0.8 * n_split_children))
    if isotropic:
        child_scaling = child_scaling[:, :1]

    def move(leaf, s0_val=None, s1_val=None, zero_new=False):
        """Keep survivors, scatter new entries into their dest slots."""
        keep = keep_mask.reshape((c,) + (1,) * (leaf.ndim - 1))
        out = torch.cat([torch.where(keep, leaf, torch.zeros_like(leaf)),
                         leaf.new_zeros((1,) + tuple(leaf.shape[1:]))])
        if not zero_new:
            out[dests] = torch.cat([leaf,
                                    leaf if s0_val is None else s0_val,
                                    leaf if s1_val is None else s1_val])
        return out[:c]

    new_params = type(p)(
        xyz=move(p.xyz, child_xyz0, child_xyz1),
        features_dc=move(p.features_dc),
        features_rest=move(p.features_rest),
        scaling=move(p.scaling, child_scaling, child_scaling),
        rotation=move(p.rotation),
        opacity=move(p.opacity),
    )
    new_aux = {
        name: tree_map(
            lambda leaf: move(leaf, zero_new=name.startswith(("mu_", "nu_"))),
            tree)
        for name, tree in aux.items()
    }
    new_alive = torch.cat([keep_mask, keep_mask.new_zeros((1,))])
    with host_read():
        new_alive[dests] = True
    new_alive = new_alive[:c]

    new_store = GaussianStore(params=new_params, alive=new_alive,
                              time=move(store.time),
                              time_ind=move(store.time_ind))

    placed = torch.sum((dests < c) & torch.cat(
        [clone_mask, place_mask, place_mask]))
    requested = n_clone + 2 * torch.sum(place_mask.long())
    info = DensifyInfo(
        num_cloned=n_clone.to(torch.int32),
        num_split=torch.sum(split_src.long()).to(torch.int32),
        num_pruned=torch.sum(prune_mask.long()).to(torch.int32),
        dropped=(requested - placed).to(torch.int32),
    )
    # stats reset after densification (`densification_postfix`)
    return new_store, new_aux, init_stats(c, device=dev), info


@torch.no_grad()
def reset_opacity(store: GaussianStore, mu_opacity: torch.Tensor,
                  nu_opacity: torch.Tensor):
    """Clamp the opacity of alive Gaussians to <= 0.01 and zero that leaf's
    Adam moments."""
    op = get_opacity(store.params)[:, None]
    new_op = inverse_sigmoid(torch.clamp(op, max=0.01))
    new_op = torch.where(store.alive[:, None], new_op, store.params.opacity)
    params = store.params._replace(opacity=new_op)
    return (store._replace(params=params),
            torch.zeros_like(mu_opacity), torch.zeros_like(nu_opacity))
