"""Mean k-nearest-neighbour squared distance (the `distCUDA2` contract of
the initial scale prior). Port of `rodygs_tpu/ops/knn.py::mean_knn_sqdist`.

Blocked over query rows so the N x N distance matrix is never held whole:
each block is one [B, N] product through the dot-product identity
||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b (as the JAX package computes it),
followed by `topk`.
"""

from __future__ import annotations

import torch


def mean_knn_sqdist(points: torch.Tensor, k: int = 3,
                    valid_mask: torch.Tensor | None = None,
                    block_size: int = 2048) -> torch.Tensor:
    """Mean squared distance of each point to its k nearest OTHER points
    (exact; the nearest hit, the self-match, is dropped)."""
    n = points.shape[0]
    pn = torch.sum(points * points, dim=1)
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    for s in range(0, n, block_size):
        q = points[s:s + block_size]
        d = torch.clamp(pn[s:s + block_size, None] + pn[None, :]
                        - 2.0 * (q @ points.T), min=0.0)
        if valid_mask is not None:
            d = torch.where(valid_mask[None, :], d, torch.inf)
        best = torch.topk(d, k + 1, dim=1, largest=False, sorted=True).values
        out[s:s + block_size] = torch.mean(best[:, 1:], dim=1)
    return out
