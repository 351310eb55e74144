"""Public differentiable renderer. Port of `rodygs_tpu/render/rasterize.py`
(compact path, one device, fp32 payload).

`render()` takes activated per-Gaussian tensors and a `Camera` and returns
the JAX package's output dict: rendered_image / rendered_depth /
rendered_normal / rendered_alpha / radii / visibility_filter /
num_fragments / overflow / dropped. It runs on the device of its inputs.

Gradient path: params -> preprocess (torch autograd) -> composite_compact
(autograd.Function over the expand / tile-forward kernels, backward through
the tile-backward and segsum kernels) -> image.

The screen-space densification gradient is reproduced functionally: pass a
zero [2, N] tensor with requires_grad as `means2d_offset`; its gradient is
dL/d(means2d) in the reference's scaled-NDC units (dL/dpixel * 0.5*[W, H]),
the units its 2e-4 densification threshold is set in. The JAX package adds
the offset divided by 0.5*[W, H] where this multiplies, so its statistic is
(0.5*[W, H])^2 smaller (ROADMAP, faults found in the reference).

Sort bands come from a `(profile, bands)` fragment profile (the trainers'
pollers and the evaluator choose them) or from `sort_bands`, which wins.

Not ported yet (ROADMAP queue 1 items 11 and 12): the legacy
`binning_mode`, tile / gauss sharding axes, the bf16 payload, the
`fwd_records` / `bwd_unsort` variants and the `RODYGS_*` environment knobs.
"""

from __future__ import annotations

import torch

from ..utils.platform import strict_fp32
from .binning import tile_grid
from .camera import Camera
from .compact import (build_binning, build_table, composite_compact,
                      fragment_capacity, padded_width, split_profile)
from .preprocess import preprocess
from .tile_kernel import tiles_to_image

# the adaptive tight-rect default of the JAX package: per-tile-row spans
# when the tile grid is large (any 1080p render), the alpha-AABB below
_ROWS_AUTO_TILES = 4096


def _default_tight(num_tiles: int):
    return "rows" if num_tiles >= _ROWS_AUTO_TILES else True


def render(
    means3d: torch.Tensor,
    shs: torch.Tensor,
    opacity: torch.Tensor,
    scaling: torch.Tensor,
    rotation: torch.Tensor,
    camera: Camera,
    sh_degree: int,
    image_width: int,
    image_height: int,
    bg: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    alive: torch.Tensor | None = None,
    means2d_offset: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    fragment_profile: str | int = "lean",
    include_normal: bool = True,
    tight_rect: bool | str | None = None,
    pose_grad_only: bool = False,
    sort_bands: int | None = None,
) -> dict:
    """Differentiable tile rasterization of N Gaussians.

    means3d [N,3], shs [N,K,3], activated opacity [N] / scaling [N,3], raw
    quaternion rotation [N,4]. `fragment_profile` sets the fragment
    capacity (compact.fragment_capacity) and, as a (profile, bands) tuple,
    the sort bands; `sort_bands` overrides the profile's band count;
    `tight_rect` overrides the adaptive binning default.
    """
    if means3d.is_cuda:
        strict_fp32()
    tiles_x, tiles_y = tile_grid(image_width, image_height)
    splats = preprocess(
        means3d, scaling, rotation, opacity, shs, sh_degree, camera,
        image_width, image_height, scale_modifier, alive=alive,
        colors_precomp=colors_precomp, pose_grad_only=pose_grad_only)
    if means2d_offset is not None:
        scale = torch.tensor([[0.5 * image_width], [0.5 * image_height]],
                             dtype=torch.float32, device=means3d.device)
        splats = splats._replace(mean2d=splats.mean2d + means2d_offset * scale)

    num_tiles = tiles_x * tiles_y
    n = splats.mean2d.shape[1]
    capacity = fragment_capacity(n, fragment_profile)
    tight = _default_tight(num_tiles) if tight_rect is None else tight_rect
    _, bands = split_profile(fragment_profile)
    if sort_bands is not None:
        bands = sort_bands
    bands = max(1, min(bands, tiles_y))
    cb = build_binning(splats, tiles_x, tiles_y, capacity, tight=tight,
                       bands=bands)
    nw = padded_width(n)
    rec13 = torch.cat([
        splats.mean2d,                 # rows 0:2
        splats.conic,                  # rows 2:5
        splats.opacity[None, :],       # row 5
        splats.rgb,                    # rows 6:9
        splats.depth[None, :],         # row 9
        splats.normal,                 # rows 10:13
    ], dim=0)
    rec13 = torch.nn.functional.pad(rec13, (0, nw - n))
    if bands > 1:
        # the bands share the record rows: autograd of the stack sums the
        # bands' [B, R, Nw] table cotangent into them
        table = torch.stack([build_table(rec13, cb.aux_rows[b])
                             for b in range(bands)])
    else:
        table = build_table(rec13, cb.aux_rows)
    tile_out = composite_compact(
        table, cb.bases, cb.f_kept, cb.tile_starts, cb.tile_counts,
        torch.zeros((1,), dtype=torch.int32, device=means3d.device),
        tiles_x, tiles_y, include_normal)
    img = tiles_to_image(tile_out, tiles_x, tiles_y, image_width, image_height)

    rgb = img[:, :, 0:3]
    depth = img[:, :, 3]
    normal = img[:, :, 4:7]
    if not include_normal:
        # the normal rows never entered the sort: a structurally-zero plane
        normal = torch.zeros_like(normal).detach()
    alpha = img[:, :, 7]
    if bg is not None:
        rgb = rgb + (1.0 - alpha)[:, :, None] * bg[None, None, :]

    return {
        "rendered_image": rgb,
        "rendered_depth": depth,
        "rendered_normal": normal,
        "rendered_alpha": alpha,
        "radii": splats.radius,
        "visibility_filter": splats.radius > 0,
        "num_fragments": cb.num_fragments,
        "overflow": cb.overflow,
        "dropped": cb.dropped,
    }
