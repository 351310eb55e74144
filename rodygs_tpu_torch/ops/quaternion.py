"""Quaternion / rotation math (torch, fully differentiable).

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


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> quaternions [..., 4] (w,x,y,z):
    branch-free selection of the best-conditioned of four candidates."""
    batch = m.shape[:-2]
    f = m.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = [f[..., i] for i in range(9)]

    def _sqrt_pos(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    q_abs = torch.stack(
        [
            _sqrt_pos(1.0 + m00 + m11 + m22),
            _sqrt_pos(1.0 + m00 - m11 - m22),
            _sqrt_pos(1.0 - m00 + m11 - m22),
            _sqrt_pos(1.0 - m00 - m11 + m22),
        ],
        dim=-1,
    )
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )  # [..., 4cand, 4comp]
    denom = 2.0 * torch.clamp(q_abs[..., None], min=0.1)
    cand = cand / denom
    best = torch.argmax(q_abs, dim=-1)
    onehot = torch.nn.functional.one_hot(best, 4).to(m.dtype)
    return torch.sum(cand * onehot[..., None], dim=-2)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] (w,x,y,z)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
