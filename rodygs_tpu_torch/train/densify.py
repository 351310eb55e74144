"""Densification statistics. Port of the statistics part of
`rodygs_tpu/train/densify.py` (`DensifyStats`, `init_stats`,
`accumulate_stats`); `densify_and_prune` and `reset_opacity` are not
ported yet (ROADMAP queue 1 item 7)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.platform import resolve_device


class DensifyStats(NamedTuple):
    """Accumulated screen-space gradient statistics."""

    grad_accum: torch.Tensor   # [C]
    denom: torch.Tensor        # [C]
    max_radii2d: torch.Tensor  # [C] float (pixel radii)


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
