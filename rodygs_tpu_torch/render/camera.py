"""Camera representation: a NamedTuple of tensors. Port of
`rodygs_tpu/render/camera.py`.

Whether a pose is learnable is a property of which tensors require grad:
the trainer indexes its [F, 4] / [F, 3] pose tensors, so pose gradients
flow through `world_view_transform` back to them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.transforms import projection_matrix, view_from_c2w_quat
from ..utils.platform import resolve_device

ZNEAR = 0.01
ZFAR = 100.0


class Camera(NamedTuple):
    """q_c2w [4] (w,x,y,z), t_c2w [3], fovx/fovy scalars (radians), time."""

    q_c2w: torch.Tensor
    t_c2w: torch.Tensor
    fovx: torch.Tensor
    fovy: torch.Tensor
    time: torch.Tensor


def make_camera(q_c2w, t_c2w, fovx, fovy, time=0.0, device=None) -> Camera:
    """A camera on `device` (`cuda` unless the caller asks for the CPU)."""
    device = resolve_device(device)

    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=torch.float32, device=device)
        return torch.tensor(x, dtype=torch.float32, device=device)

    return Camera(q_c2w=f32(q_c2w), t_c2w=f32(t_c2w), fovx=f32(fovx),
                  fovy=f32(fovy), time=f32(time))


def camera_from_w2c(R_w2c, t_w2c, fovx, fovy, time=0.0, device=None) -> Camera:
    """Build from a world-to-camera (R, t): R_c2w = R^T, t_c2w = -R^T t."""
    from ..ops.quaternion import matrix_to_quat

    device = resolve_device(device)
    R = torch.tensor(np.asarray(R_w2c, np.float32), device=device)
    t = torch.tensor(np.asarray(t_w2c, np.float32), device=device)
    return make_camera(matrix_to_quat(R.T), -R.T @ t, fovx, fovy, time,
                       device=device)


def world_view_transform(cam: Camera) -> torch.Tensor:
    """4x4 world->camera, differentiable w.r.t. (q_c2w, t_c2w)."""
    return view_from_c2w_quat(cam.q_c2w, cam.t_c2w)


def proj_matrix(cam: Camera) -> torch.Tensor:
    return projection_matrix(ZNEAR, ZFAR, cam.fovx, cam.fovy)


def camera_center(cam: Camera) -> torch.Tensor:
    return cam.t_c2w
