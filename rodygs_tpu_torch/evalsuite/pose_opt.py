"""Test-time per-camera pose optimisation. Port of
`rodygs_tpu/evalsuite/pose_opt.py`.

For each test view: find the two nearest train cameras by GT camera-centre
distance, start from the nearest CALIBRATED train pose, then take
`num_opts` Adam steps (eps 1e-15) on the photometric L2 through the
pose-differentiable renderer. The JAX package runs the steps as one
`lax.fori_loop` inside a jit; here they are a plain Python loop of eager
steps (each a render forward and backward), which the host paces.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.quaternion import matrix_to_quat
from ..render.camera import Camera
from ..train.optim import adam_init, adam_update


def search_nearest_two(query_pose: np.ndarray, db_poses: np.ndarray) -> np.ndarray:
    """Indices of the 2 nearest db poses by camera-center distance."""
    d = np.linalg.norm(db_poses[:, :3, 3] - query_pose[None, :3, 3], axis=1)
    return np.argsort(d)[:2]


class PoseOptimizer:
    """`render_fn(camera) -> [H, W, 3]` must be differentiable w.r.t. the
    camera's q_c2w and t_c2w."""

    def __init__(self, calibrated_poses: np.ndarray,
                 uncalibrated_poses: np.ndarray,
                 render_fn: Callable[[Camera], torch.Tensor],
                 camera_lr: float, num_opts: int):
        self.calibrated_poses = np.asarray(calibrated_poses)
        self.uncalibrated_poses = np.asarray(uncalibrated_poses)
        self.render_fn = render_fn
        self.camera_lr = float(camera_lr)
        self.num_opts = int(num_opts)

    def step(self, pose, opt, camera: Camera, gt_rgb: torch.Tensor):
        """One Adam step on (q, t); returns ((q, t), opt, loss)."""
        q, t = (x.detach().requires_grad_(True) for x in pose)
        pred = self.render_fn(camera._replace(q_c2w=q, t_c2w=t))
        loss = torch.mean((pred - gt_rgb) ** 2)
        grads = torch.autograd.grad(loss, (q, t))
        pose, opt = adam_update(grads, opt, (q.detach(), t.detach()),
                                self.camera_lr)
        return pose, opt, loss.detach()

    def optimize(self, q0: torch.Tensor, t0: torch.Tensor, camera: Camera,
                 gt_rgb: torch.Tensor):
        pose = (q0, t0)
        opt = adam_init(pose)
        for _ in range(self.num_opts):
            pose, opt, _ = self.step(pose, opt, camera, gt_rgb)
        return pose

    def __call__(self, camera: Camera, gt_c2w: np.ndarray, gt_rgb) -> Camera:
        nearest = search_nearest_two(gt_c2w, self.uncalibrated_poses)
        init_pose = self.calibrated_poses[nearest[0]]
        dev = camera.q_c2w.device
        q0 = matrix_to_quat(torch.tensor(init_pose[:3, :3], dtype=torch.float32,
                                         device=dev))
        t0 = torch.tensor(init_pose[:3, 3], dtype=torch.float32, device=dev)
        gt = torch.as_tensor(gt_rgb, dtype=torch.float32, device=dev)
        q, t = self.optimize(q0, t0, camera, gt)
        return camera._replace(q_c2w=q, t_c2w=t)
