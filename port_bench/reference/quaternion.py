"""Frozen copy of `rodygs_tpu_torch/ops/quaternion.py` (the parts the
benchmark's plain reference uses): later changes to the program do not
reach it. The original docstring follows.

Quaternion / rotation math (torch, fully differentiable).

Port of `rodygs_tpu/ops/quaternion.py`. Convention: scalar-first (w, x, y, z).
"""

from __future__ import annotations

import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] to unit norm.

    sqrt(|q|^2 + eps^2) rather than max(|q|, eps): the norm's gradient at
    q=0 is NaN even under a max guard, and zero quaternions do occur (dead
    capacity slots)."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps * eps)


def quat_to_matrix(q: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """Quaternion(s) [..., 4] (w,x,y,z, not necessarily unit) -> rotation
    matrices [..., 3, 3], with the 2/|q|^2 normalization so gradients flow
    through the norm. `eps` guards q=0."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / (torch.sum(q * q, dim=-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (y * y + z * z),
            two_s * (x * y - z * w),
            two_s * (x * z + y * w),
            two_s * (x * y + z * w),
            1 - two_s * (x * x + z * z),
            two_s * (y * z - x * w),
            two_s * (x * z - y * w),
            two_s * (y * z + x * w),
            1 - two_s * (x * x + y * y),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


