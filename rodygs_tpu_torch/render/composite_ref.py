"""Dense reference compositor: plain per-pixel alpha blending of every
(pixel, gaussian) pair. Port of `rodygs_tpu/render/composite_ref.py`.

The oracle of `render()` that depends on neither the binning, the kernels
nor their plain versions: depth-argsort all gaussians, evaluate every pair,
composite front to back with an exclusive cumulative-product transmittance.
Autograd differentiates straight through it. O(H*W*N) memory and work:
small scenes only.

Blending follows the reference CUDA `renderCUDA` loop: alpha = min(0.99,
opacity * exp(-sigma)), skipped where sigma < 0 or alpha < 1/255, and a
gaussian touches only the pixels of the tiles its radius rect covers (as
the binned renderers cull); a fragment contributes while the transmittance
after it stays >= 1e-4; out = sum(w_i * f_i) + T_final * bg on the colour
channels.
"""

from __future__ import annotations

import torch

from .binning import TILE, tile_grid, tile_rect
from .preprocess import Splats2D

ALPHA_EPS = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99


def composite_reference(splats: Splats2D, image_width: int, image_height: int,
                        bg: torch.Tensor | None = None) -> dict:
    """Composite all splats at every pixel. Returns channels-last image
    [H, W, 3], depth [H, W], normal [H, W, 3] and alpha [H, W]."""
    dev = splats.depth.device
    order = torch.argsort(torch.where(splats.visible, splats.depth,
                                      torch.inf), stable=True)
    mean2d = splats.mean2d[:, order]     # [2, N]
    conic = splats.conic[:, order]       # [3, N]
    rgb = splats.rgb[:, order].T         # [N, 3]
    opac = splats.opacity[order]
    depth = splats.depth[order]
    normal = splats.normal[:, order].T   # [N, 3]
    visible = splats.visible[order]
    radius = splats.radius[order]

    ys = torch.arange(image_height, dtype=torch.float32, device=dev)
    xs = torch.arange(image_width, dtype=torch.float32, device=dev)
    pyy, pxx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]

    dx = pxx[:, :, None] - mean2d[0][None, None, :]   # [H, W, N]
    dy = pyy[:, :, None] - mean2d[1][None, None, :]
    sigma = (0.5 * (conic[0][None, None, :] * dx * dx
                    + conic[2][None, None, :] * dy * dy)
             + conic[1][None, None, :] * dx * dy)
    g = torch.exp(-sigma)
    alpha = torch.clamp(opac[None, None, :] * g, max=ALPHA_MAX)

    # the tile cull of the binned renderers: a gaussian reaches only the
    # pixels of the tiles its radius rect covers
    tiles_x, tiles_y = tile_grid(image_width, image_height)
    xmin, ymin, xmax, ymax = tile_rect(mean2d.detach(), radius, tiles_x,
                                       tiles_y)
    ptx = torch.div(pxx, TILE, rounding_mode="floor").to(torch.int32)[:, :, None]
    pty = torch.div(pyy, TILE, rounding_mode="floor").to(torch.int32)[:, :, None]
    in_rect = ((ptx >= xmin) & (ptx < xmax) & (pty >= ymin) & (pty < ymax))
    keep = (sigma >= 0) & (alpha >= ALPHA_EPS) & visible & in_rect
    alpha = torch.where(keep, alpha, 0.0)

    # a fragment contributes while the transmittance after it is >= 1e-4
    log_t = torch.cumsum(torch.log(torch.clamp(1.0 - alpha, min=1e-10)), dim=2)
    t_incl = torch.exp(log_t)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :, :1]), t_incl[:, :, :-1]],
                       dim=2)
    w = torch.where(t_incl >= T_EPS, alpha * t_excl, 0.0)   # [H, W, N]

    out_rgb = torch.einsum("hwn,nc->hwc", w, rgb)
    out_depth = w @ depth
    out_normal = torch.einsum("hwn,nc->hwc", w, normal)
    out_alpha = w.sum(dim=2)
    if bg is not None:
        out_rgb = out_rgb + (1.0 - out_alpha)[:, :, None] * bg[None, None, :]
    return {
        "rendered_image": out_rgb,
        "rendered_depth": out_depth,
        "rendered_normal": out_normal,
        "rendered_alpha": out_alpha,
    }
