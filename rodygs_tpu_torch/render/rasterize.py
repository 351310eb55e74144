"""Public differentiable renderer. Port of `rodygs_tpu/render/rasterize.py`.

`render()` takes activated per-Gaussian tensors and a `Camera` and returns
the JAX package's output dict: rendered_image / rendered_depth /
rendered_normal / rendered_alpha / radii / visibility_filter /
num_fragments / overflow / dropped. It runs on the device of its inputs.

Two binning backends (`binning_mode`):
  * "compact" (default): params -> preprocess (torch autograd) ->
    composite_compact (autograd.Function over the expand / tile-forward
    kernels, backward through the tile-backward and segsum kernels) ->
    image. Options, per call or chosen by the code: sort bands and the
    tight-rect modes.
  * "legacy": the broadcast-tier binning (render/binning.py), a records
    gather `index_select` whose backward is the scatter-add `index_add_`,
    and `tile_kernel.rasterize_tiles` (the tile-forward / tile-backward
    kernels). Profiles "lean" and "wide"; spans past the top tier are
    clamped and reported as `overflow`, with `dropped` = -1.

The screen-space densification gradient is reproduced functionally: pass a
zero [2, N] tensor with requires_grad as `means2d_offset`; its gradient is
dL/d(means2d) in the reference's scaled-NDC units (dL/dpixel * 0.5*[W, H]),
the units its 2e-4 densification threshold is set in. The JAX package adds
the offset divided by 0.5*[W, H] where this multiplies, so its statistic is
(0.5*[W, H])^2 smaller (ROADMAP, faults found in the reference).

Sort bands come from a `(profile, bands)` fragment profile (the trainers'
pollers and the evaluator choose them) or from `sort_bands`, which wins.
The count is clamped to [1, tiles_y], as the JAX package clamps
`sort_bands`. The tight-rect mode is `tight_rect`, or by default row spans
from 4,096 tiles up and the alpha-AABB below.

Sharding, inside a multi-process mesh (parallel/mesh.py); each argument
takes a mesh `Axis`, the composite `mesh.axis(("gauss", "tile"))`
included:
  * `tile_axis`: the axis over which the tile grid splits. This rank
    composites one contiguous block of ceil(T/n) tiles (the last block
    padded with zero-count tiles) at its global tile offset; the planes
    come back together through a tiled all-gather, whose backward hands
    each rank exactly its own tiles' cotangents.
  * `gauss_axis`: the axis over which the Gaussian store is split. The
    inputs are this rank's block; the projected Splats2D fields are
    all-gathered along their last dimension (one gather of the packed
    fields), and the gather's backward (a reduce-scatter) returns each
    block exactly its own gradients. radii / visibility_filter cover the
    whole gathered set, in block order: callers take their own block.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather
from ..utils.platform import strict_fp32
from ..utils.profiling import count, host_read, span
from .binning import CHUNK, DUMMY_COLS, bin_splats, tile_grid
from .camera import Camera
from .compact import (FCHUNK, build_binning, build_table, composite_compact,
                      fragment_capacity, padded_width, split_profile)
from .preprocess import Splats2D, preprocess
from .tile_kernel import (rasterize_tiles, rasterize_tiles_ranged,
                          tiles_to_image)

_ROWS_AUTO_TILES = 4096


def _default_tight(num_tiles: int):
    """Row spans on large tile grids, else the alpha-AABB."""
    return "rows" if num_tiles >= _ROWS_AUTO_TILES else True


def _band_count(fragment_profile, sort_bands, tiles_y: int) -> int:
    """sort_bands, else the profile's; in [1, tiles_y]."""
    bands = (split_profile(fragment_profile)[1] if sort_bands is None
             else sort_bands)
    return max(1, min(bands, tiles_y))


def default_fragment_budget(image_width: int, image_height: int, n: int) -> int:
    """Static fragment capacity: a generous multiple of (tiles + gaussians),
    CHUNK-rounded with a floor for tiny scenes."""
    tiles_x, tiles_y = tile_grid(image_width, image_height)
    budget = max(32 * n, 8 * tiles_x * tiles_y * CHUNK // 16)
    budget = max(budget, 1 << 16)
    return -(-budget // CHUNK) * CHUNK


def _pack_records(splats: Splats2D) -> torch.Tensor:
    """Field-major [16, N + DUMMY_COLS] record matrix of the legacy path:
    the trailing all-zero columns serve the dummy fragment ids."""
    n = splats.mean2d.shape[1]
    ones = splats.mean2d.new_ones((1, n))
    rec = torch.cat([
        splats.mean2d,                    # rows 0:2
        splats.conic,                     # rows 2:5
        splats.opacity[None, :],          # row 5
        splats.rgb,                       # rows 6:9
        splats.depth[None, :],            # row 9
        splats.normal,                    # rows 10:13
        ones,                             # row 13 (the alpha feature)
        splats.mean2d.new_zeros((2, n)),  # rows 14:16 pad
    ], dim=0)
    return torch.cat([rec, rec.new_zeros((16, DUMMY_COLS))], dim=1)


def _gather_splats(splats: Splats2D, axis) -> Splats2D:
    """The axis's Splats2D blocks concatenated along N: the fields packed
    into one [R, N] float32 tensor for a single differentiable gather (the
    int32 radius, below 2^24, and the bool visibility ride along exactly)."""
    fields = [splats.mean2d, splats.conic, splats.depth[None], splats.rgb,
              splats.opacity[None], splats.normal,
              splats.radius[None].to(torch.float32),
              splats.visible[None].to(torch.float32), splats.ext]
    rows = [f.shape[0] for f in fields]
    parts = all_gather(torch.cat(fields), axis, dim=1).split(rows)
    mean2d, conic, depth, rgb, opacity, normal, radius, visible, ext = parts
    return Splats2D(mean2d=mean2d, conic=conic, depth=depth[0], rgb=rgb,
                    opacity=opacity[0], normal=normal,
                    radius=radius[0].to(torch.int32),
                    visible=visible[0] > 0.5, ext=ext)


def tile_block(tile_starts, tile_counts, n_blocks: int, index: int,
               num_tiles: int):
    """Block `index` of `n_blocks` contiguous blocks of the tile ranges:
    (starts, counts, [1] i32 global id of its first tile). Blocks hold
    ceil(T/n) tiles; the last is padded with zero-count tiles."""
    t_local = -(-num_tiles // n_blocks)
    t0 = index * t_local
    pad = n_blocks * t_local - num_tiles
    starts = torch.nn.functional.pad(tile_starts, (0, pad))
    counts = torch.nn.functional.pad(tile_counts, (0, pad))
    offset = torch.tensor([t0], dtype=torch.int32, device=tile_starts.device)
    return (starts[t0:t0 + t_local], counts[t0:t0 + t_local], offset)


def _gather_tiles(local_out, axis, num_tiles: int):
    return all_gather(local_out, axis, dim=0)[:num_tiles]


@span("render")
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
    max_fragments: int | None = None,
    fragment_profile: str | int = "lean",
    binning_mode: str = "compact",
    include_normal: bool = True,
    tight_rect: bool | str | None = None,
    pose_grad_only: bool = False,
    sort_bands: int | None = None,
    tile_axis=None,
    gauss_axis=None,
) -> dict:
    """Differentiable tile rasterization of N Gaussians.

    means3d [N,3], shs [N,K,3], activated opacity [N] / scaling [N,3], raw
    quaternion rotation [N,4]. `fragment_profile` sets the fragment
    capacity (compact.fragment_capacity; legacy: binning.FRAGMENT_PROFILES)
    and, as a (profile, bands) tuple, the sort bands; `sort_bands`
    overrides the profile's band count; `tight_rect` overrides the binning
    default. `max_fragments` is accepted and not used, as in the JAX
    package: both binnings size their capacity from N and the profile. The
    compact-path options do not apply to the legacy path. `tile_axis` /
    `gauss_axis`: see the module docstring.
    """
    if means3d.is_cuda:
        strict_fp32()
    tiles_x, tiles_y = tile_grid(image_width, image_height)
    with span("preprocess"):
        splats = preprocess(
            means3d, scaling, rotation, opacity, shs, sh_degree, camera,
            image_width, image_height, scale_modifier, alive=alive,
            colors_precomp=colors_precomp, pose_grad_only=pose_grad_only)
    if means2d_offset is not None:
        with host_read():
            scale = torch.tensor([[0.5 * image_width],
                                  [0.5 * image_height]],
                                 dtype=torch.float32, device=means3d.device)
        splats = splats._replace(mean2d=splats.mean2d + means2d_offset * scale)
    if gauss_axis is not None:
        splats = _gather_splats(splats, gauss_axis)

    num_tiles = tiles_x * tiles_y
    if binning_mode == "compact":
        n = splats.mean2d.shape[1]
        capacity = fragment_capacity(n, fragment_profile)
        tight = _default_tight(num_tiles) if tight_rect is None else tight_rect
        bands = _band_count(fragment_profile, sort_bands, tiles_y)
        with span("binning"):
            cb = build_binning(splats, tiles_x, tiles_y, capacity,
                               tight=tight, bands=bands)
        count("fragments", cb.num_fragments)
        count("fragment_slots", cb.bases.numel() * FCHUNK)
        count("dropped_fragments", cb.dropped)
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
        if tile_axis is None:
            starts, counts = cb.tile_starts, cb.tile_counts
            offset = torch.zeros((1,), dtype=torch.int32,
                                 device=means3d.device)
        else:
            starts, counts, offset = tile_block(
                cb.tile_starts, cb.tile_counts, tile_axis.size,
                tile_axis.index, num_tiles)
        tile_out = composite_compact(
            table, cb.bases, cb.f_kept, starts, counts, offset, tiles_x,
            tiles_y, include_normal, bands)
        if tile_axis is not None:
            tile_out = _gather_tiles(tile_out, tile_axis, num_tiles)
        num_fragments, overflow, dropped = (cb.num_fragments, cb.overflow,
                                            cb.dropped)
    elif binning_mode == "legacy":
        if max_fragments is None:
            max_fragments = default_fragment_budget(
                image_width, image_height, means3d.shape[0])
        binning = bin_splats(
            splats.mean2d.detach(), splats.depth.detach(), splats.radius,
            splats.visible, tiles_x, tiles_y, max_fragments,
            profile=fragment_profile)
        # the gather's backward is the scatter-add index_add_
        padded = _pack_records(splats).index_select(1, binning.padded_gid)
        if tile_axis is None:
            tile_out = rasterize_tiles(padded, binning.tile_starts,
                                       binning.tile_counts, tiles_x)
        else:
            starts, counts, offset = tile_block(
                binning.tile_starts, binning.tile_counts, tile_axis.size,
                tile_axis.index, num_tiles)
            tile_out = _gather_tiles(rasterize_tiles_ranged(
                padded, starts, counts, offset, tiles_x), tile_axis,
                num_tiles)
        num_fragments, overflow = binning.num_fragments, binning.overflow
        # spans are clamped, not whole gaussians dropped: no exact count
        dropped = torch.where(overflow, -1, 0).to(torch.int32)
    else:
        raise ValueError(f"binning_mode {binning_mode!r}: expected 'compact' "
                         "or 'legacy'")
    img = tiles_to_image(tile_out, tiles_x, tiles_y, image_width, image_height)

    rgb = img[:, :, 0:3]
    depth = img[:, :, 3]
    normal = img[:, :, 4:7]
    if not include_normal:
        # no normal plane is exposed: a structurally-zero one, no cotangent
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
        "num_fragments": num_fragments,
        "overflow": overflow,
        "dropped": dropped,
    }
