"""Frozen copy of `rodygs_tpu_torch/render/preprocess.py` (the parts the
benchmark's plain reference uses): later changes to the program do not
reach it. The original docstring follows.

Gaussian preprocessing: projection, EWA splatting, frustum culling, SH.

Port of `rodygs_tpu/render/preprocess.py`: the same component-wise formulas
over [N] vectors, with outputs row-major [D, N] (`Splats2D`, trailing N).
Plain PyTorch; autograd provides every backward path, including the
camera-pose gradient through `world_view_transform`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sh import C0, C1, C2, C3
from .camera import Camera, camera_center, proj_matrix, world_view_transform

NEAR_CULL_Z = 0.2          # near-plane cull threshold of the reference kernel
COV2D_DILATION = 0.3       # low-pass dilation of the 2D covariance (px^2)


class Splats2D(NamedTuple):
    """Per-Gaussian screen-space quantities (transposed: trailing dim N)."""

    mean2d: torch.Tensor     # [2, N] pixel coords
    conic: torch.Tensor      # [3, N] inverse 2D covariance (a, b, c)
    depth: torch.Tensor      # [N] view-space z
    rgb: torch.Tensor        # [3, N] SH-evaluated color
    opacity: torch.Tensor    # [N] activated opacity
    normal: torch.Tensor     # [3, N] view-space normal (shortest axis)
    radius: torch.Tensor     # [N] int32 pixel radius (0 => culled)
    visible: torch.Tensor    # [N] bool
    ext: torch.Tensor        # [2, N] f32 alpha-cut rect half-extents (px)


def _sh_eval_components(deg: int, sh_t: torch.Tensor, dx, dy, dz):
    """SH -> (r, g, b) on [N] vectors; sh_t: [K, 3, N]."""
    out = [C0 * sh_t[0, c] for c in range(3)]
    if deg > 0:
        for c in range(3):
            out[c] = (out[c] - C1 * dy * sh_t[1, c] + C1 * dz * sh_t[2, c]
                      - C1 * dx * sh_t[3, c])
        if deg > 1:
            xx, yy, zz = dx * dx, dy * dy, dz * dz
            xy, yz, xz = dx * dy, dy * dz, dx * dz
            for c in range(3):
                out[c] = (out[c]
                          + C2[0] * xy * sh_t[4, c]
                          + C2[1] * yz * sh_t[5, c]
                          + C2[2] * (2.0 * zz - xx - yy) * sh_t[6, c]
                          + C2[3] * xz * sh_t[7, c]
                          + C2[4] * (xx - yy) * sh_t[8, c])
            if deg > 2:
                for c in range(3):
                    out[c] = (out[c]
                              + C3[0] * dy * (3 * xx - yy) * sh_t[9, c]
                              + C3[1] * xy * dz * sh_t[10, c]
                              + C3[2] * dy * (4 * zz - xx - yy) * sh_t[11, c]
                              + C3[3] * dz * (2 * zz - 3 * xx - 3 * yy) * sh_t[12, c]
                              + C3[4] * dx * (4 * zz - xx - yy) * sh_t[13, c]
                              + C3[5] * dz * (xx - yy) * sh_t[14, c]
                              + C3[6] * dx * (xx - 3 * yy) * sh_t[15, c])
    return [torch.clamp(o + 0.5, min=0.0) for o in out]


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: torch.Tensor,
    sh_degree: int,
    camera: Camera,
    image_width: int,
    image_height: int,
    scale_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    pose_grad_only: bool = False,
) -> Splats2D:
    """Project N Gaussians into screen space.

    means3d [N,3]; scales [N,3] activated; quats [N,4]; opacities [N]
    activated; shs [N,K,3]. `alive` masks capacity slots (dead => invisible,
    with NaN-safe quaternions); `colors_precomp` [N,3] overrides SH;
    `pose_grad_only` detaches conic/rgb/normal/opacity so the backward
    flows only through mean2d + depth.
    """
    w2c = world_view_transform(camera)
    P = proj_matrix(camera)
    full_proj = P @ w2c
    V = [[w2c[i, j] for j in range(4)] for i in range(3)]
    F = [[full_proj[i, j] for j in range(4)] for i in range(4)]

    m_t = means3d.T
    s_t = scales.T
    q_t = quats.T
    mx, my, mz = m_t[0], m_t[1], m_t[2]
    sx, sy, sz = (s_t[0] * scale_modifier, s_t[1] * scale_modifier,
                  s_t[2] * scale_modifier)
    qw, qx, qy, qz = q_t[0], q_t[1], q_t[2], q_t[3]

    # NaN hygiene: dead slots hold all-zero params; inf/NaN produced for them
    # would poison every gradient that sums over Gaussians (the pose).
    if alive is not None:
        one, zero = torch.ones_like(qw), torch.zeros_like(qw)
        qw = torch.where(alive, qw, one)
        qx = torch.where(alive, qx, zero)
        qy = torch.where(alive, qy, zero)
        qz = torch.where(alive, qz, zero)

    tx_v = V[0][0] * mx + V[0][1] * my + V[0][2] * mz + V[0][3]
    ty_v = V[1][0] * mx + V[1][1] * my + V[1][2] * mz + V[1][3]
    depth = V[2][0] * mx + V[2][1] * my + V[2][2] * mz + V[2][3]
    depth_ok = depth >= NEAR_CULL_Z

    hx = F[0][0] * mx + F[0][1] * my + F[0][2] * mz + F[0][3]
    hy = F[1][0] * mx + F[1][1] * my + F[1][2] * mz + F[1][3]
    hw = F[3][0] * mx + F[3][1] * my + F[3][2] * mz + F[3][3]
    inv_w = 1.0 / torch.where(depth_ok, hw + 1e-7, torch.ones_like(hw))
    # ndc2Pix of the reference kernel: ((ndc + 1) * S - 1) * 0.5
    px = ((hx * inv_w + 1.0) * image_width - 1.0) * 0.5
    py = ((hy * inv_w + 1.0) * image_height - 1.0) * 0.5

    # EWA: 2D covariance = J W Sigma W^T J^T with clamped frustum coords.
    tan_x = torch.tan(camera.fovx * 0.5)
    tan_y = torch.tan(camera.fovy * 0.5)
    focal_x = image_width / (2.0 * tan_x)
    focal_y = image_height / (2.0 * tan_y)
    tz = torch.where(depth_ok, depth, torch.ones_like(depth))
    lim_x = 1.3 * tan_x
    lim_y = 1.3 * tan_y
    txc = torch.minimum(torch.maximum(tx_v / tz, -lim_x), lim_x) * tz
    tyc = torch.minimum(torch.maximum(ty_v / tz, -lim_y), lim_y) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * txc * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * tyc * inv_z2

    qn2 = qw * qw + qx * qx + qy * qy + qz * qz + 1e-24
    two_s = 2.0 / qn2
    r00 = 1 - two_s * (qy * qy + qz * qz)
    r01 = two_s * (qx * qy - qz * qw)
    r02 = two_s * (qx * qz + qy * qw)
    r10 = two_s * (qx * qy + qz * qw)
    r11 = 1 - two_s * (qx * qx + qz * qz)
    r12 = two_s * (qy * qz - qx * qw)
    r20 = two_s * (qx * qz - qy * qw)
    r21 = two_s * (qy * qz + qx * qw)
    r22 = 1 - two_s * (qx * qx + qy * qy)

    sx2, sy2, sz2 = sx * sx, sy * sy, sz * sz
    c00 = r00 * r00 * sx2 + r01 * r01 * sy2 + r02 * r02 * sz2
    c01 = r00 * r10 * sx2 + r01 * r11 * sy2 + r02 * r12 * sz2
    c02 = r00 * r20 * sx2 + r01 * r21 * sy2 + r02 * r22 * sz2
    c11 = r10 * r10 * sx2 + r11 * r11 * sy2 + r12 * r12 * sz2
    c12 = r10 * r20 * sx2 + r11 * r21 * sy2 + r12 * r22 * sz2
    c22 = r20 * r20 * sx2 + r21 * r21 * sy2 + r22 * r22 * sz2

    t00 = j00 * V[0][0] + j02 * V[2][0]
    t01 = j00 * V[0][1] + j02 * V[2][1]
    t02 = j00 * V[0][2] + j02 * V[2][2]
    t10 = j11 * V[1][0] + j12 * V[2][0]
    t11 = j11 * V[1][1] + j12 * V[2][1]
    t12 = j11 * V[1][2] + j12 * V[2][2]

    u00 = t00 * c00 + t01 * c01 + t02 * c02
    u01 = t00 * c01 + t01 * c11 + t02 * c12
    u02 = t00 * c02 + t01 * c12 + t02 * c22
    u10 = t10 * c00 + t11 * c01 + t12 * c02
    u11 = t10 * c01 + t11 * c11 + t12 * c12
    u12 = t10 * c02 + t11 * c12 + t12 * c22
    a = u00 * t00 + u01 * t01 + u02 * t02 + COV2D_DILATION
    b = u00 * t10 + u01 * t11 + u02 * t12
    c = u10 * t10 + u11 * t11 + u12 * t12 + COV2D_DILATION

    det = a * c - b * b
    det_ok = det > 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    con_a = c * inv_det
    con_b = -b * inv_det
    con_c = a * inv_det

    # screen radius: 3 sigma of the max eigenvalue (0.1 discriminant floor)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))

    # alpha-cut AABB half-extents for tight binning (index structure only)
    op_safe = torch.clamp(opacities, min=1e-12)
    t_cut = torch.clamp(2.0 * torch.log(255.0 * op_safe), min=0.0)
    ext_x = torch.sqrt(t_cut * a) * 1.00001 + 1e-3
    ext_y = torch.sqrt(t_cut * c) * 1.00001 + 1e-3
    ext = torch.stack([ext_x, ext_y], dim=0).detach()

    if colors_precomp is None:
        campos = camera_center(camera)
        dx = mx - campos[0]
        dy = my - campos[1]
        dz = mz - campos[2]
        # sqrt(x+eps), not max(norm, eps): the norm's gradient at 0 is NaN
        dn = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-16)
        sh_t = shs.permute(1, 2, 0)
        r, g, b_ = _sh_eval_components(
            sh_degree, sh_t, dx * dn, dy * dn, dz * dn)
        rgb = torch.stack([r, g, b_], dim=0)
    else:
        rgb = colors_precomp.T

    # view-space normal: shortest principal axis, flipped to face the camera
    x_short = sx <= torch.minimum(sy, sz)
    y_short = sy <= sz
    ax_x = torch.where(x_short, r00, torch.where(y_short, r01, r02))
    ax_y = torch.where(x_short, r10, torch.where(y_short, r11, r12))
    ax_z = torch.where(x_short, r20, torch.where(y_short, r21, r22))
    nvx = V[0][0] * ax_x + V[0][1] * ax_y + V[0][2] * ax_z
    nvy = V[1][0] * ax_x + V[1][1] * ax_y + V[1][2] * ax_z
    nvz = V[2][0] * ax_x + V[2][1] * ax_y + V[2][2] * ax_z
    flip = torch.where(nvz > 0, -1.0, 1.0)

    visible = depth_ok & det_ok & (radius_f > 0)
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).detach().to(torch.int32)

    conic = torch.stack([con_a, con_b, con_c], dim=0)
    normal = torch.stack([nvx * flip, nvy * flip, nvz * flip], dim=0)
    if pose_grad_only:
        conic = conic.detach()
        rgb = rgb.detach()
        normal = normal.detach()
        opacities = opacities.detach()

    return Splats2D(
        mean2d=torch.stack([px, py], dim=0),
        conic=conic,
        depth=depth,
        rgb=rgb,
        opacity=opacities,
        normal=normal,
        radius=radius,
        visible=visible,
        ext=ext,
    )
