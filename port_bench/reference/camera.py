"""Frozen copy of `rodygs_tpu_torch/render/camera.py` (the parts the
benchmark's plain reference uses): later changes to the program do not
reach it. The original docstring follows.

Camera representation: a NamedTuple of tensors. Port of
`rodygs_tpu/render/camera.py`.

Whether a pose is learnable is a property of which tensors require grad:
the trainer indexes its [F, 4] / [F, 3] pose tensors, so pose gradients
flow through `world_view_transform` back to them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .transforms import projection_matrix, view_from_c2w_quat

ZNEAR = 0.01
ZFAR = 100.0


class Camera(NamedTuple):
    """q_c2w [4] (w,x,y,z), t_c2w [3], fovx/fovy scalars (radians), time."""

    q_c2w: torch.Tensor
    t_c2w: torch.Tensor
    fovx: torch.Tensor
    fovy: torch.Tensor
    time: torch.Tensor


def world_view_transform(cam: Camera) -> torch.Tensor:
    """4x4 world->camera, differentiable w.r.t. (q_c2w, t_c2w)."""
    return view_from_c2w_quat(cam.q_c2w, cam.t_c2w)


def proj_matrix(cam: Camera) -> torch.Tensor:
    return projection_matrix(ZNEAR, ZFAR, cam.fovx, cam.fovy)


def camera_center(cam: Camera) -> torch.Tensor:
    return cam.t_c2w
