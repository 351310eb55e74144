"""Gaussian preprocessing: projection, EWA splatting, frustum culling, SH.

Port of `rodygs_tpu/render/preprocess.py`: the same component-wise formulas
over [N] vectors, with outputs row-major [D, N] (`Splats2D`, trailing N).

`preprocess` runs the projection as one `torch.autograd.Function`. On a
CUDA tensor its forward is one launch of `csrc/preprocess.cu`, which takes
the plain version's rounded operations in their order (the same radius,
visibility and binning), and its backward one launch that recomputes the
forward from the saved inputs, plus a fixed-order reduction of the camera's
gradient when the pose needs one. On a CPU tensor the forward is the plain
version's arithmetic under `no_grad` and the backward is
`preprocess_backward_plain`: the kernel's hand-derived chain rule in torch
ops, term for term. The camera matrices (`world_view_transform`,
`proj_matrix`, their product, `camera_center`) are built outside the
Function, so autograd carries their gradient on to the pose.

`preprocess_plain` is the formula-by-formula version whose gradients come
from autograd: the tests' oracle for both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..ops.sh import C0, C1, C2, C3
from ..utils.profiling import count
from .camera import Camera, camera_center, proj_matrix, world_view_transform

NEAR_CULL_Z = 0.2          # near-plane cull threshold of the reference kernel
COV2D_DILATION = 0.3       # low-pass dilation of the 2D covariance (px^2)
# the SH degrees csrc/preprocess.cu is instantiated for
KERNEL_SH_DEGREES = (0, 1, 2, 3)
# threads a block of the backward kernel: one camera partial per block
BWD_THREADS = 256
CAM_PARTIALS = 27          # w2c rows 0-2, full_proj rows 0, 1, 3, campos


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
    """SH + 0.5 -> (r, g, b) on [N] vectors, before the clamp at 0;
    sh_t: [K, 3, N]."""
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
    return [o + 0.5 for o in out]


class _Terms(NamedTuple):
    """The plain version's intermediates that its outputs and the hand
    backward read, [N] vectors (camera scalars 0-dim)."""

    mx: torch.Tensor
    my: torch.Tensor
    mz: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor
    q: tuple                 # qw, qx, qy, qz after the dead-slot hygiene
    depth: torch.Tensor
    depth_ok: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    inv_w: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    focal: tuple             # focal_x, focal_y
    lim: tuple               # lim_x, lim_y
    tz: torch.Tensor
    u: tuple                 # tx_v / tz, ty_v / tz
    tc: tuple                # txc, tyc
    inv_z: torch.Tensor
    inv_z2: torch.Tensor
    j: tuple                 # j00, j02, j11, j12
    two_s: torch.Tensor
    r: tuple                 # r00 .. r22, row-major
    s2: tuple                # sx2, sy2, sz2
    cov: tuple               # c00, c01, c02, c11, c12, c22
    t: tuple                 # t00 .. t12, row-major
    uu: tuple                # u00 .. u12, row-major
    abc: tuple               # a, b, c
    det_ok: torch.Tensor
    inv_det: torch.Tensor
    conic: tuple             # con_a, con_b, con_c
    radius_f: torch.Tensor
    ext: torch.Tensor | None
    dirs: tuple | None       # the unit view direction, its 1 / norm, d
    rgb_pre: list | None     # SH + 0.5 before the clamp
    axis: tuple              # x_short, y_short
    ax: tuple                # the shortest axis, a column of R
    nv: tuple                # nvx, nvy, nvz before the flip
    flip: torch.Tensor


def _terms(means3d, scales, quats, opacities, shs, sh_degree, V, F, campos,
           fovx, fovy, image_width, image_height, scale_modifier, alive,
           with_sh) -> _Terms:
    """The plain version's formulas on [N] vectors. V, F: the 4x4 view and
    full-projection matrices as lists of 0-dim rows; `opacities` None skips
    the alpha-cut extents, `with_sh` False the SH colour."""
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
    tan_x = torch.tan(fovx * 0.5)
    tan_y = torch.tan(fovy * 0.5)
    focal_x = image_width / (2.0 * tan_x)
    focal_y = image_height / (2.0 * tan_y)
    tz = torch.where(depth_ok, depth, torch.ones_like(depth))
    lim_x = 1.3 * tan_x
    lim_y = 1.3 * tan_y
    ux = tx_v / tz
    uy = ty_v / tz
    txc = torch.minimum(torch.maximum(ux, -lim_x), lim_x) * tz
    tyc = torch.minimum(torch.maximum(uy, -lim_y), lim_y) * tz
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
    ext = None
    if opacities is not None:
        op_safe = torch.clamp(opacities, min=1e-12)
        t_cut = torch.clamp(2.0 * torch.log(255.0 * op_safe), min=0.0)
        ext_x = torch.sqrt(t_cut * a) * 1.00001 + 1e-3
        ext_y = torch.sqrt(t_cut * c) * 1.00001 + 1e-3
        ext = torch.stack([ext_x, ext_y], dim=0).detach()

    dirs = rgb_pre = None
    if with_sh:
        dx = mx - campos[0]
        dy = my - campos[1]
        dz = mz - campos[2]
        # sqrt(x+eps), not max(norm, eps): the norm's gradient at 0 is NaN
        dn = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-16)
        dirs = (dx * dn, dy * dn, dz * dn, dn, (dx, dy, dz))
        sh_t = shs.permute(1, 2, 0)
        rgb_pre = _sh_eval_components(sh_degree, sh_t, *dirs[:3])

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

    return _Terms(
        mx, my, mz, sx, sy, sz, (qw, qx, qy, qz), depth, depth_ok, hx, hy,
        inv_w, px, py, (focal_x, focal_y), (lim_x, lim_y), tz, (ux, uy),
        (txc, tyc), inv_z, inv_z2, (j00, j02, j11, j12), two_s,
        (r00, r01, r02, r10, r11, r12, r20, r21, r22), (sx2, sy2, sz2),
        (c00, c01, c02, c11, c12, c22), (t00, t01, t02, t10, t11, t12),
        (u00, u01, u02, u10, u11, u12), (a, b, c), det_ok, inv_det,
        (con_a, con_b, con_c), radius_f, ext, dirs, rgb_pre,
        (x_short, y_short), (ax_x, ax_y, ax_z), (nvx, nvy, nvz), flip)


def _rows(mat: torch.Tensor, n_rows: int):
    return [[mat[i, j] for j in range(4)] for i in range(n_rows)]


def _camera(camera: Camera):
    """The camera as the Function takes it: the 4x4 view matrix, the full
    projection P @ w2c and the camera centre, differentiable in the pose."""
    w2c = world_view_transform(camera)
    return w2c, proj_matrix(camera) @ w2c, camera_center(camera)


def _project_plain(means3d, scales, quats, opacities, shs, sh_degree, w2c,
                   full_proj, campos, fovx, fovy, image_width, image_height,
                   scale_modifier, alive, colors_precomp):
    """The eight fields of `Splats2D` but the opacity, by the plain
    formulas."""
    t = _terms(means3d, scales, quats, opacities, shs, sh_degree,
               _rows(w2c, 3), _rows(full_proj, 4), campos, fovx, fovy,
               image_width, image_height, scale_modifier, alive,
               colors_precomp is None)
    if colors_precomp is None:
        rgb = torch.stack([torch.clamp(o, min=0.0) for o in t.rgb_pre], dim=0)
    else:
        rgb = colors_precomp.T
    visible = t.depth_ok & t.det_ok & (t.radius_f > 0)
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, t.radius_f, 0.0).detach().to(torch.int32)
    return (torch.stack([t.px, t.py], dim=0), torch.stack(t.conic, dim=0),
            t.depth, rgb, torch.stack([n * t.flip for n in t.nv], dim=0),
            radius, visible, t.ext)


def _splats(fields, opacities, pose_grad_only) -> Splats2D:
    mean2d, conic, depth, rgb, normal, radius, visible, ext = fields
    if pose_grad_only:
        conic = conic.detach()
        rgb = rgb.detach()
        normal = normal.detach()
        opacities = opacities.detach()
    return Splats2D(mean2d=mean2d, conic=conic, depth=depth, rgb=rgb,
                    opacity=opacities, normal=normal, radius=radius,
                    visible=visible, ext=ext)


def preprocess_plain(
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
    """`preprocess` formula by formula over [N] vectors, with autograd's
    gradients: the oracle of the Function's forward and backward."""
    w2c, full_proj, campos = _camera(camera)
    return _splats(_project_plain(
        means3d, scales, quats, opacities, shs, sh_degree, w2c, full_proj,
        campos, camera.fovx, camera.fovy, image_width, image_height,
        scale_modifier, alive, colors_precomp), opacities, pose_grad_only)


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
    flows only through mean2d + depth. On a CUDA tensor one kernel launch
    forward and one or two backward (the module docstring); it raises for
    what the kernel does not take (another dtype, an SH degree outside
    KERNEL_SH_DEGREES, tensors on other devices).
    """
    w2c, full_proj, campos = _camera(camera)
    if pose_grad_only:   # conic, rgb and normal are all they reach
        scales, quats, shs = scales.detach(), quats.detach(), shs.detach()
        if colors_precomp is not None:
            colors_precomp = colors_precomp.detach()
    inputs = tuple(None if x is None else x.contiguous() for x in (
        means3d, scales, quats, shs, colors_precomp, w2c, full_proj, campos))
    const = (opacities.detach().contiguous(), alive, camera.fovx,
             camera.fovy, sh_degree, image_width, image_height,
             scale_modifier)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        fields = _Preprocess.apply(*inputs, *const)
    else:
        fields = _forward(*inputs, *const)
    return _splats(fields, opacities, pose_grad_only)


def _forward(means3d, scales, quats, shs, colors_precomp, w2c, full_proj,
             campos, opacities, alive, fovx, fovy, sh_degree, image_width,
             image_height, scale_modifier):
    if means3d.is_cuda:
        return preprocess_cuda_fwd(
            means3d, scales, quats, shs, colors_precomp, w2c, full_proj,
            campos, opacities, alive, fovx, fovy, sh_degree, image_width,
            image_height, scale_modifier)
    with torch.no_grad():
        return _project_plain(means3d, scales, quats, opacities, shs,
                              sh_degree, w2c, full_proj, campos, fovx, fovy,
                              image_width, image_height, scale_modifier,
                              alive, colors_precomp)


class _Preprocess(torch.autograd.Function):
    """The projection stage: inputs means3d, scales, quats, shs,
    colors_precomp, w2c, full_proj, campos (differentiable), then the
    opacities, alive, fovx, fovy and the Python parameters. Outputs mean2d,
    conic, depth, rgb, normal (differentiable), radius, visible, ext. Saves
    the inputs only; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, shs, colors_precomp, w2c,
                full_proj, campos, opacities, alive, fovx, fovy, sh_degree,
                image_width, image_height, scale_modifier):
        out = _forward(means3d, scales, quats, shs, colors_precomp, w2c,
                       full_proj, campos, opacities, alive, fovx, fovy,
                       sh_degree, image_width, image_height, scale_modifier)
        ctx.mark_non_differentiable(*out[5:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, quats, shs, w2c, full_proj,
                              campos, alive, fovx, fovy)
        ctx.params = (sh_degree, image_width, image_height, scale_modifier,
                      colors_precomp is not None)
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_depth, g_rgb, g_normal, *_):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:8]
        grads = (g_mean2d, g_conic, g_depth, g_rgb, g_normal)
        back = (preprocess_cuda_bwd if saved[0].is_cuda
                else preprocess_backward_plain)
        return (*back(*saved, *ctx.params, grads, needs), *([None] * 8))


def preprocess_backward_plain(means3d, scales, quats, shs, w2c, full_proj,
                              campos, alive, fovx, fovy, sh_degree,
                              image_width, image_height, scale_modifier,
                              has_colors, grads, needs):
    """The Function's backward in torch ops: the chain rule that
    csrc/preprocess.cu's backward computes, term for term, from the inputs
    (the forward recomputed). `grads` are the cotangents of mean2d, conic,
    depth, rgb and normal (None: zero); `needs` says which of means3d,
    scales, quats, shs, colors_precomp, w2c, full_proj and campos take a
    gradient. Returns those eight gradients, None where not needed.

    The conventions are autograd's of the plain version: nothing through a
    `where` branch not taken (the near cull, det <= 0, dead slots'
    quaternions), the frustum clamp and the colour clamp at 0 (>= passes;
    a tie of the frustum clamp passes half, as torch.maximum / minimum
    do), radius, ext, visibility or the normal's choice of axis."""
    with torch.no_grad():
        V, F = _rows(w2c, 3), _rows(full_proj, 4)
        t = _terms(means3d, scales, quats, None, shs, sh_degree, V, F,
                   campos, fovx, fovy, image_width, image_height,
                   scale_modifier, alive, not has_colors)
        return _backward_terms(t, V, F, shs, sh_degree, alive, image_width,
                               image_height, scale_modifier, has_colors,
                               grads, needs)


def _sh_basis(deg: int, x, y, z):
    """The SH basis at the unit direction (x, y, z), (deg + 1)^2 functions,
    and each one's derivative by x, y and z (None where it is 0)."""
    basis = [C0 + 0.0 * x]
    dbasis = [(None, None, None)]
    if deg > 0:
        basis += [-C1 * y, C1 * z, -C1 * x]
        dbasis += [(None, -C1, None), (None, None, C1), (-C1, None, None)]
    if deg > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                  C2[3] * xz, C2[4] * (xx - yy)]
        dbasis += [(C2[0] * y, C2[0] * x, None),
                   (None, C2[1] * z, C2[1] * y),
                   (-2.0 * C2[2] * x, -2.0 * C2[2] * y, 4.0 * C2[2] * z),
                   (C2[3] * z, None, C2[3] * x),
                   (2.0 * C2[4] * x, -2.0 * C2[4] * y, None)]
    if deg > 2:
        basis += [C3[0] * y * (3.0 * xx - yy),
                  C3[1] * xy * z,
                  C3[2] * y * (4.0 * zz - xx - yy),
                  C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  C3[4] * x * (4.0 * zz - xx - yy),
                  C3[5] * z * (xx - yy),
                  C3[6] * x * (xx - 3.0 * yy)]
        dbasis += [(C3[0] * 6.0 * xy, C3[0] * 3.0 * (xx - yy), None),
                   (C3[1] * yz, C3[1] * xz, C3[1] * xy),
                   (-2.0 * C3[2] * xy, C3[2] * (4.0 * zz - xx - 3.0 * yy),
                    8.0 * C3[2] * yz),
                   (-6.0 * C3[3] * xz, -6.0 * C3[3] * yz,
                    C3[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy)),
                   (C3[4] * (4.0 * zz - 3.0 * xx - yy), -2.0 * C3[4] * xy,
                    8.0 * C3[4] * xz),
                   (2.0 * C3[5] * xz, -2.0 * C3[5] * yz, C3[5] * (xx - yy)),
                   (C3[6] * 3.0 * (xx - yy), -6.0 * C3[6] * xy, None)]
    return basis, dbasis


def _backward_terms(t, V, F, shs, deg, alive, W, H, smod, has_colors, grads,
                    needs):
    zero = torch.zeros_like(t.mx)

    def split(g, n):
        return [zero] * n if g is None else [g[i] for i in range(n)]

    g_mean2d, g_conic, g_depth, g_rgb, g_normal = grads
    gpx, gpy = split(g_mean2d, 2)
    gca, gcb, gcc = split(g_conic, 3)
    gdep = zero if g_depth is None else g_depth
    fx, fy = t.focal
    (j00, j02, j11, j12), inv_z, inv_z2 = t.j, t.inv_z, t.inv_z2
    a, b, c = t.abc
    tt = [t.t[:3], t.t[3:]]
    u0, u1 = t.uu[:3], t.uu[3:]
    c00, c01, c02, c11, c12, c22 = t.cov
    C = [[c00, c01, c02], [c01, c11, c12], [c02, c12, c22]]
    R = [t.r[0:3], t.r[3:6], t.r[6:9]]

    # mean2d: px = ((hx inv_w + 1) W - 1) / 2, inv_w = 1 / (hw + 1e-7)
    g_hx = gpx * (0.5 * W) * t.inv_w
    g_hy = gpy * (0.5 * H) * t.inv_w
    g_iw = gpx * (0.5 * W) * t.hx + gpy * (0.5 * H) * t.hy
    g_hw = torch.where(t.depth_ok, -g_iw * t.inv_w * t.inv_w, 0.0)

    # conic = (c, -b, a) / det
    g_idet = gca * c - gcb * b + gcc * a
    g_det = torch.where(t.det_ok, -g_idet * t.inv_det * t.inv_det, 0.0)
    g_a = gcc * t.inv_det + g_det * c
    g_b = -gcb * t.inv_det - 2.0 * g_det * b
    g_c = gca * t.inv_det + g_det * a

    # a = u0.t0 + 0.3, b = u0.t1, c = u1.t1 + 0.3, u_i = t_i C
    g_u0 = [g_a * tt[0][k] + g_b * tt[1][k] for k in range(3)]
    g_u1 = [g_c * tt[1][k] for k in range(3)]
    g_t0 = [g_a * u0[k] + g_u0[0] * C[k][0] + g_u0[1] * C[k][1]
            + g_u0[2] * C[k][2] for k in range(3)]
    g_t1 = [g_b * u0[k] + g_c * u1[k] + g_u1[0] * C[k][0]
            + g_u1[1] * C[k][1] + g_u1[2] * C[k][2] for k in range(3)]
    gC = [[tt[0][i] * g_u0[k] + tt[1][i] * g_u1[k] for k in range(3)]
          for i in range(3)]

    # t0 = j00 V0 + j02 V2, t1 = j11 V1 + j12 V2
    g_j00 = g_t0[0] * V[0][0] + g_t0[1] * V[0][1] + g_t0[2] * V[0][2]
    g_j02 = g_t0[0] * V[2][0] + g_t0[1] * V[2][1] + g_t0[2] * V[2][2]
    g_j11 = g_t1[0] * V[1][0] + g_t1[1] * V[1][1] + g_t1[2] * V[1][2]
    g_j12 = g_t1[0] * V[2][0] + g_t1[1] * V[2][1] + g_t1[2] * V[2][2]
    gV = [[None] * 4 for _ in range(3)]
    for k in range(3):
        gV[0][k] = g_t0[k] * j00
        gV[1][k] = g_t1[k] * j11
        gV[2][k] = g_t0[k] * j02 + g_t1[k] * j12

    # the Jacobian from tz and the clamped frustum coordinates
    txc, tyc = t.tc
    g_iz2 = -(g_j02 * fx * txc + g_j12 * fy * tyc)
    g_iz = g_j00 * fx + g_j11 * fy + 2.0 * inv_z * g_iz2
    g_txc = -g_j02 * fx * inv_z2
    g_tyc = -g_j12 * fy * inv_z2
    g_tz = -g_iz * inv_z * inv_z
    g_tv = []
    for u, g_tc, lim in zip(t.u, (g_txc, g_tyc), t.lim):
        v = torch.maximum(u, -lim)
        inside = (torch.where(u > -lim, 1.0, torch.where(u == -lim, 0.5, 0.0))
                  * torch.where(v < lim, 1.0, torch.where(v == lim, 0.5, 0.0)))
        g_tz = g_tz + g_tc * torch.minimum(v, lim)
        g_u = g_tc * t.tz * inside
        g_tv.append(g_u / t.tz)
        g_tz = g_tz - g_u * u / t.tz
    g_tx, g_ty = g_tv
    g_dep = gdep + torch.where(t.depth_ok, g_tz, 0.0)

    # normal = flip * V3 ax, ax the shortest axis's column of R
    gR = [[zero] * 3 for _ in range(3)]
    if g_normal is not None:
        g_nv = [g_normal[i] * t.flip for i in range(3)]
        for j in range(3):
            g_ax = g_nv[0] * V[0][j] + g_nv[1] * V[1][j] + g_nv[2] * V[2][j]
            x_short, y_short = t.axis
            for k in range(3):
                pick = x_short if k == 0 else (~x_short & y_short if k == 1
                                               else ~x_short & ~y_short)
                gR[j][k] = gR[j][k] + torch.where(pick, g_ax, 0.0)
            for i in range(3):
                gV[i][j] = gV[i][j] + g_nv[i] * t.ax[j]

    # Sigma = R diag(s^2) R^T: dR = (gC + gC^T) R diag(s^2)
    Msym = [[gC[i][k] + gC[k][i] for k in range(3)] for i in range(3)]
    g_s = []
    for k in range(3):
        for i in range(3):
            gR[i][k] = gR[i][k] + t.s2[k] * (Msym[i][0] * R[0][k]
                                             + Msym[i][1] * R[1][k]
                                             + Msym[i][2] * R[2][k])
        g_s2 = sum(gC[i][j] * R[i][k] * R[j][k] for i in range(3)
                   for j in range(3))
        g_s.append(g_s2 * 2.0 * (t.sx, t.sy, t.sz)[k] * smod)

    # R = I + two_s P(q), two_s = 2 / |q|^2
    qw, qx, qy, qz = t.q
    g = gR
    ts = t.two_s
    g_two_s = (-g[0][0] * (qy * qy + qz * qz) + g[0][1] * (qx * qy - qz * qw)
               + g[0][2] * (qx * qz + qy * qw) + g[1][0] * (qx * qy + qz * qw)
               - g[1][1] * (qx * qx + qz * qz) + g[1][2] * (qy * qz - qx * qw)
               + g[2][0] * (qx * qz - qy * qw) + g[2][1] * (qy * qz + qx * qw)
               - g[2][2] * (qx * qx + qy * qy))
    g_qn2 = -0.5 * g_two_s * ts * ts
    g_q = [
        ts * (-g[0][1] * qz + g[0][2] * qy + g[1][0] * qz - g[1][2] * qx
              - g[2][0] * qy + g[2][1] * qx),
        ts * (g[0][1] * qy + g[0][2] * qz + g[1][0] * qy - 2.0 * g[1][1] * qx
              - g[1][2] * qw + g[2][0] * qz + g[2][1] * qw
              - 2.0 * g[2][2] * qx),
        ts * (-2.0 * g[0][0] * qy + g[0][1] * qx + g[0][2] * qw
              + g[1][0] * qx + g[1][2] * qz - g[2][0] * qw + g[2][1] * qz
              - 2.0 * g[2][2] * qy),
        ts * (-2.0 * g[0][0] * qz - g[0][1] * qw + g[0][2] * qx
              + g[1][0] * qw - 2.0 * g[1][1] * qz + g[1][2] * qy
              + g[2][0] * qx + g[2][1] * qy),
    ]
    g_q = [gq + 2.0 * q * g_qn2 for gq, q in zip(g_q, t.q)]
    if alive is not None:
        g_q = [torch.where(alive, gq, 0.0) for gq in g_q]

    # colour: SH at the unit view direction, clamped at 0
    m = (t.mx, t.my, t.mz)
    g_m = [V[0][k] * g_tx + V[1][k] * g_ty + V[2][k] * g_dep
           + F[0][k] * g_hx + F[1][k] * g_hy + F[3][k] * g_hw
           for k in range(3)]
    g_sh = g_cols = g_v = None
    if not has_colors:
        g_o = split(g_rgb, 3)
        g_o = [torch.where(pre >= 0.0, go, 0.0)
               for go, pre in zip(g_o, t.rgb_pre)]
        x, y, z, dn, _ = t.dirs
        basis, dbasis = _sh_basis(deg, x, y, z)
        sh_t = shs.permute(1, 2, 0)
        if needs[3]:
            g_sh = torch.zeros_like(shs)
            for k, bk in enumerate(basis):
                g_sh[:, k, :] = torch.stack([g_o[ch] * bk for ch in range(3)],
                                            dim=1)
        g_dir = [zero, zero, zero]
        for k, dk in enumerate(dbasis):
            s_k = g_o[0] * sh_t[k, 0] + g_o[1] * sh_t[k, 1] + g_o[2] * sh_t[k, 2]
            for i in range(3):
                if dk[i] is not None:
                    g_dir[i] = g_dir[i] + s_k * dk[i]
        dot = g_dir[0] * x + g_dir[1] * y + g_dir[2] * z
        g_v = [dn * (g_dir[i] - (x, y, z)[i] * dot) for i in range(3)]
        g_m = [g_m[k] + g_v[k] for k in range(3)]
    elif needs[4] and g_rgb is not None:
        g_cols = g_rgb.T
    elif needs[4]:
        g_cols = torch.zeros((zero.shape[0], 3), dtype=zero.dtype,
                             device=zero.device)

    out = [None] * 8
    if needs[0]:
        out[0] = torch.stack(g_m, dim=1)
    if needs[1]:
        out[1] = torch.stack(g_s, dim=1)
    if needs[2]:
        out[2] = torch.stack(g_q, dim=1)
    if needs[3] and not has_colors:
        out[3] = g_sh
    out[4] = g_cols
    if needs[5]:
        out[5] = torch.zeros((4, 4), dtype=zero.dtype, device=zero.device)
        for i, g_row in enumerate((g_tx, g_ty, g_dep)):
            for k in range(3):
                out[5][i, k] = torch.sum(gV[i][k] + g_row * m[k])
            out[5][i, 3] = torch.sum(g_row)
    if needs[6]:
        out[6] = torch.zeros((4, 4), dtype=zero.dtype, device=zero.device)
        for i, g_row in ((0, g_hx), (1, g_hy), (3, g_hw)):
            for k in range(3):
                out[6][i, k] = torch.sum(g_row * m[k])
            out[6][i, 3] = torch.sum(g_row)
    if needs[7]:
        out[7] = (torch.zeros(3, dtype=zero.dtype, device=zero.device)
                  if g_v is None else -torch.stack([torch.sum(gv)
                                                    for gv in g_v]))
    return out


def _check_cuda_inputs(means3d, scales, quats, shs, colors_precomp, w2c,
                       full_proj, campos, opacities, alive, fovx, fovy,
                       sh_degree):
    """Raise for what csrc/preprocess.cu does not take."""
    n = means3d.shape[0]
    if colors_precomp is None and sh_degree not in KERNEL_SH_DEGREES:
        raise ValueError(f"preprocess: the kernel takes SH degrees "
                         f"{KERNEL_SH_DEGREES}, not {sh_degree}")
    shapes = [("means3d", means3d, (n, 3)), ("scales", scales, (n, 3)),
              ("quats", quats, (n, 4)), ("opacities", opacities, (n,)),
              ("w2c", w2c, (4, 4)), ("full_proj", full_proj, (4, 4)),
              ("campos", campos, (3,)), ("fovx", fovx, ()),
              ("fovy", fovy, ())]
    if colors_precomp is None:
        k_min = (sh_degree + 1) ** 2
        if shs.ndim != 3 or shs.shape[0] != n or shs.shape[1] < k_min \
                or shs.shape[2] != 3:
            raise ValueError(f"preprocess shs: expected [{n}, >= {k_min}, 3],"
                             f" got {tuple(shs.shape)}")
        kernels.check_cuda(shs, "preprocess shs", torch.float32, 3)
    else:
        shapes.append(("colors_precomp", colors_precomp, (n, 3)))
    for name, x, shape in shapes:
        if tuple(x.shape) != shape:
            raise ValueError(f"preprocess {name}: expected {list(shape)}, got "
                             f"{list(x.shape)}")
        kernels.check_cuda(x, f"preprocess {name}", torch.float32, len(shape))
    if alive is not None:
        if tuple(alive.shape) != (n,):
            raise ValueError(f"preprocess alive: expected [{n}], got "
                             f"{list(alive.shape)}")
        kernels.check_cuda(alive, "preprocess alive", torch.bool, 1)
    if any(x.device != means3d.device for _, x, _ in shapes) or (
            alive is not None and alive.device != means3d.device):
        raise ValueError("preprocess: every input on one card")


def preprocess_cuda_fwd(means3d, scales, quats, shs, colors_precomp, w2c,
                        full_proj, campos, opacities, alive, fovx, fovy,
                        sh_degree, image_width, image_height,
                        scale_modifier):
    """The forward as one launch of csrc/preprocess.cu: (mean2d, conic,
    depth, rgb, normal, radius, visible, ext)."""
    _check_cuda_inputs(means3d, scales, quats, shs, colors_precomp, w2c,
                       full_proj, campos, opacities, alive, fovx, fovy,
                       sh_degree)
    n = means3d.shape[0]
    f32 = dict(dtype=torch.float32, device=means3d.device)
    out = (torch.empty((2, n), **f32), torch.empty((3, n), **f32),
           torch.empty((n,), **f32), torch.empty((3, n), **f32),
           torch.empty((3, n), **f32),
           torch.empty((n,), dtype=torch.int32, device=means3d.device),
           torch.empty((n,), dtype=torch.bool, device=means3d.device),
           torch.empty((2, n), **f32))
    if n:
        deg = -1 if colors_precomp is not None else sh_degree
        kernels.launch("preprocess_fwd", means3d, scales, quats, shs, n,
                       shs.shape[1], deg, alive, colors_precomp, opacities,
                       w2c, full_proj, campos, fovx, fovy, image_width,
                       image_height, scale_modifier, *out)
        count("preprocess_launches", 1)
    return out


def _rows_arg(g):
    """A [R, N] cotangent as the kernel reads it: the tensor (its last
    stride 1) and its row stride; None for none."""
    if g is None:
        return None, 0
    if g.stride(-1) != 1:
        g = g.contiguous()
    return g, g.stride(0) if g.ndim == 2 else 0


def preprocess_cuda_bwd(means3d, scales, quats, shs, w2c, full_proj, campos,
                        alive, fovx, fovy, sh_degree, image_width,
                        image_height, scale_modifier, has_colors, grads,
                        needs):
    """`preprocess_backward_plain`'s contract in one launch of the backward
    kernel, and one of the fixed-order camera reduction when w2c,
    full_proj or campos take a gradient."""
    n = means3d.shape[0]
    g_mean2d, g_conic, g_depth, g_rgb, g_normal = grads
    out = [None] * 8
    for k, x in enumerate((means3d, scales, quats)):
        if needs[k]:
            out[k] = torch.empty_like(x)
    if needs[3] and not has_colors:
        out[3] = torch.empty_like(shs)
    if needs[4]:
        out[4] = (g_rgb.T if g_rgb is not None else
                  torch.zeros((n, 3), dtype=torch.float32,
                              device=means3d.device))
    cam = any(needs[5:8])
    partial = None
    if cam:
        partial = torch.empty(((n + BWD_THREADS - 1) // BWD_THREADS,
                               CAM_PARTIALS), dtype=torch.float32,
                              device=means3d.device)
    if n and (cam or any(x is not None for x in out[:4])):
        gm, ld_m = _rows_arg(g_mean2d)
        gc, ld_c = _rows_arg(g_conic)
        gd, _ = _rows_arg(g_depth)
        gr, ld_r = _rows_arg(None if has_colors else g_rgb)
        gn, ld_n = _rows_arg(g_normal)
        kernels.launch("preprocess_bwd", means3d, scales, quats, shs, n,
                       shs.shape[1], -1 if has_colors else sh_degree, alive,
                       w2c, full_proj, campos, fovx, fovy, image_width,
                       image_height, scale_modifier, gm, ld_m, gc, ld_c, gd,
                       gr, ld_r, gn, ld_n, *out[:4], partial)
        count("preprocess_launches", 1)
    if cam:
        for k, x in ((5, w2c), (6, full_proj), (7, campos)):
            if needs[k]:
                out[k] = torch.empty_like(x)
        kernels.launch("preprocess_reduce", partial, partial.shape[0],
                       *out[5:8])
        count("preprocess_launches", 1)
    return out
