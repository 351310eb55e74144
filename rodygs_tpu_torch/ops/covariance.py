"""3D covariance from (scale, rotation). Port of `rodygs_tpu/ops/covariance.py`."""

from __future__ import annotations

import torch

from .quaternion import quat_normalize, quat_to_matrix


def build_covariance(scaling: torch.Tensor, rotation_quat: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """[N,3] activated scales + [N,4] quats -> covariance [N,3,3],
    Sigma = R S S^T R^T with S = diag(modifier * scale)."""
    R = quat_to_matrix(quat_normalize(rotation_quat))
    L = R * (scaling * scaling_modifier)[:, None, :]
    return torch.einsum("nij,nkj->nik", L, L)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[N,3,3] symmetric -> packed upper triangle [N,6] (xx, xy, xz, yy, yz, zz)."""
    return torch.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
         cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
        dim=1,
    )


def unstrip_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `strip_symmetric`: [N,6] -> [N,3,3]."""
    xx, xy, xz, yy, yz, zz = [packed[:, i] for i in range(6)]
    return torch.stack(
        [torch.stack([xx, xy, xz], -1),
         torch.stack([xy, yy, yz], -1),
         torch.stack([xz, yz, zz], -1)],
        dim=1,
    )
