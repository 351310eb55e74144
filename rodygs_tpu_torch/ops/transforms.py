"""Camera/projection transforms (torch). Port of `rodygs_tpu/ops/transforms.py`.

World-to-view from (R, t), the OpenGL-style z-in-[0,1] perspective
projection, fov <-> focal conversions. All differentiable.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import host_read
from .quaternion import quat_to_matrix


def world_to_view(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera matrix from a w2c rotation R [3,3] and t [3]."""
    with host_read():
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                              device=R.device)
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom], dim=0)


def view_from_c2w_quat(q_c2w: torch.Tensor, t_c2w: torch.Tensor) -> torch.Tensor:
    """Differentiable world->camera 4x4 from a camera-to-world quaternion [4]
    and translation [3] — the pose-gradient path."""
    R_c2w = quat_to_matrix(q_c2w)
    R_w2c = R_c2w.T
    t_w2c = -R_w2c @ t_c2w
    return world_to_view(R_w2c, t_w2c)


def projection_matrix(znear: float, zfar: float, fovx, fovy,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    """OpenGL-convention perspective matrix with z mapped to [0, 1]."""
    fovx = torch.as_tensor(fovx, dtype=dtype, device=device)
    fovy = torch.as_tensor(fovy, dtype=dtype, device=fovx.device)
    tan_x = torch.tan(fovx * 0.5)
    tan_y = torch.tan(fovy * 0.5)
    zero = torch.zeros((), dtype=dtype, device=fovx.device)
    one = torch.ones((), dtype=dtype, device=fovx.device)
    a = zfar / (zfar - znear)
    b = -(zfar * znear) / (zfar - znear)
    rows = [
        [1.0 / tan_x, zero, zero, zero],
        [zero, 1.0 / tan_y, zero, zero],
        [zero, zero, one * a, one * b],
        [zero, zero, one, zero],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def fov2focal(fov, pixels):
    return pixels / (2.0 * math.tan(float(fov) / 2.0))


def focal2fov(focal, pixels):
    return 2.0 * math.atan(pixels / (2.0 * float(focal)))


def transform_points(points: torch.Tensor, mat4: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to [N,3] points, returning [N,3] after the
    perspective divide."""
    hom = torch.cat([points, torch.ones_like(points[:, :1])], dim=1)
    out = hom @ mat4.T
    return out[:, :3] / (out[:, 3:4] + 1e-7)
