"""The reference's differentiable renderer: the frozen preprocess, a plain
binning of its own, and the frozen plain tile compositors, tile-blocked so
that a 1920x1080 frame of half a million gaussians fits.

Binning. Each visible gaussian covers the tiles of its 3-sigma circle rect
(`tile_rect`, the CUDA getRect's truncation); the (gaussian, tile) pairs
are enumerated gaussian-major (slot ascending) and sorted stably by the key
(tile, top `depth_key_bits` bits of the float32 depth), so fragments of one
quantized depth key keep slot order. That is the order the port's compact
binning gives. The port intersects each rect with the alpha >= 1/255
ellipse's bounds, so it lists fewer fragments; a fragment it leaves out
has alpha below 1/255 at every pixel of the tile, which the compositor
skips without touching any sum, so both give the same bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import tiles as TK
from .preprocess import Splats2D, preprocess

TILE = TK.TILE
TILE_BLOCK = 2048          # tiles composited at once: [2048, 256, 128] f32
FEATURE_ROWS = 10          # mx, my, conic a b c, opacity, r, g, b, depth


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def tile_bits(tiles_x: int, tiles_y: int) -> int:
    return max(1, math.ceil(math.log2(tiles_x * tiles_y + 1)))


def depth_key_bits(tiles_x: int, tiles_y: int) -> int:
    return min(32 - tile_bits(tiles_x, tiles_y), 23)


def quantize_depth_bits(depth: torch.Tensor, db: int) -> torch.Tensor:
    """Top `db` bits of the f32 pattern (logical shift; int64 result)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (31 - db)


def tile_rect(mean2d, radius, tiles_x: int, tiles_y: int):
    """Tile rect per gaussian (truncate toward zero, clamp; exclusive max)."""
    r = radius.to(torch.float32)
    px, py = mean2d[0], mean2d[1]

    def clip(x, hi):
        return torch.clamp(x, 0, hi).to(torch.int64)

    return (clip(torch.trunc((px - r) / TILE), tiles_x),
            clip(torch.trunc((py - r) / TILE), tiles_y),
            clip(torch.trunc((px + r + TILE - 1) / TILE), tiles_x),
            clip(torch.trunc((py + r + TILE - 1) / TILE), tiles_y))


class Binning(NamedTuple):
    gid: torch.Tensor          # [F] i64 gaussian of each sorted fragment
    tile_starts: torch.Tensor  # [T] i64
    tile_counts: torch.Tensor  # [T] i64
    tiles_x: int
    tiles_y: int


@torch.no_grad()
def bin_splats(splats: Splats2D, width: int, height: int) -> Binning:
    tiles_x, tiles_y = tile_grid(width, height)
    mean2d = splats.mean2d.detach()
    xmin, ymin, xmax, ymax = tile_rect(mean2d, splats.radius, tiles_x,
                                       tiles_y)
    span_w, span_h = xmax - xmin, ymax - ymin
    vis = splats.visible & (span_w > 0) & (span_h > 0)
    cnt = torch.where(vis, span_w * span_h, 0)
    n = cnt.shape[0]
    dev = mean2d.device
    gid = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(gid.shape[0], device=dev) - first[gid]
    w = span_w[gid]
    tile = (ymin[gid] + k // w) * tiles_x + xmin[gid] + k % w
    db = depth_key_bits(tiles_x, tiles_y)
    key = (tile << db) | quantize_depth_bits(splats.depth.detach(), db)[gid]
    _, order = torch.sort(key, stable=True)
    gid = gid[order]
    counts = torch.bincount(tile, minlength=tiles_x * tiles_y)
    starts = torch.cumsum(counts, 0) - counts
    return Binning(gid, starts, counts, tiles_x, tiles_y)


def tile_blocks(b: Binning, block: int = TILE_BLOCK):
    """(first tile, end tile, first fragment, end fragment) of each block."""
    num_tiles = b.tile_counts.shape[0]
    ends = (b.tile_starts + b.tile_counts).tolist()
    starts = b.tile_starts.tolist()
    for t0 in range(0, num_tiles, block):
        t1 = min(t0 + block, num_tiles)
        yield t0, t1, starts[t0], ends[t1 - 1]


def block_records(rows: torch.Tensor, b: Binning, t0: int, t1: int, f0: int,
                  f1: int):
    """The [16, F_b] records of a block's fragments and its ranges."""
    rec = rows[:, b.gid[f0:f1]]
    pad = rec.new_zeros((TK.NUM_FIELDS - rec.shape[0], rec.shape[1]))
    rec = torch.cat([rec, pad], dim=0)
    rec[13] = 1.0
    starts = (b.tile_starts[t0:t1] - f0).to(torch.int32)
    counts = b.tile_counts[t0:t1].to(torch.int32)
    offset = torch.tensor([t0], dtype=torch.int32, device=rows.device)
    return rec, starts, counts, offset


def tiles_to_image(planes: torch.Tensor, b: Binning, width: int,
                   height: int) -> torch.Tensor:
    """[T, 8, 256] -> [H, W, 8]."""
    img = planes.reshape(b.tiles_y, b.tiles_x, TK.NUM_CHANNELS, TILE, TILE)
    img = img.permute(0, 3, 1, 4, 2).reshape(b.tiles_y * TILE,
                                             b.tiles_x * TILE,
                                             TK.NUM_CHANNELS)
    return img[:height, :width]


def image_to_tiles(img: torch.Tensor, b: Binning) -> torch.Tensor:
    """[H, W, 8] -> [T, 8, 256] (zero beyond the image)."""
    h, w, c = img.shape
    full = img.new_zeros((b.tiles_y * TILE, b.tiles_x * TILE, c))
    full[:h, :w] = img
    full = full.reshape(b.tiles_y, TILE, b.tiles_x, TILE, c)
    return full.permute(0, 2, 4, 1, 3).reshape(-1, c, TILE * TILE)


def composite_planes(rows: torch.Tensor, b: Binning) -> torch.Tensor:
    """Forward planes [T, 8, 256] of the [10, N] per-gaussian rows."""
    out = []
    for t0, t1, f0, f1 in tile_blocks(b):
        rec, starts, counts, offset = block_records(rows, b, t0, t1, f0, f1)
        out.append(TK.rasterize_fwd_plain(rec, starts, counts, offset,
                                          b.tiles_x, include_normal=False))
    return torch.cat(out, dim=0)


class _Composite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, b, width, height):
        planes = composite_planes(rows, b)
        ctx.save_for_backward(rows, planes)
        ctx.b = b
        return tiles_to_image(planes, b, width, height)

    @staticmethod
    def backward(ctx, gimg):
        rows, planes = ctx.saved_tensors
        b = ctx.b
        gout = image_to_tiles(gimg.contiguous(), b)
        d_rows = torch.zeros_like(rows)
        for t0, t1, f0, f1 in tile_blocks(b):
            rec, starts, counts, offset = block_records(rows, b, t0, t1, f0,
                                                        f1)
            d_rec = TK.rasterize_bwd_plain(
                rec, starts, counts, offset, planes[t0:t1].contiguous(),
                gout[t0:t1].contiguous(), b.tiles_x, include_normal=False)
            d_rows.index_add_(1, b.gid[f0:f1], d_rec[:FEATURE_ROWS])
        return d_rows, None, None, None


def render(means3d, shs, opacity, scaling, rotation, camera, sh_degree: int,
           width: int, height: int, alive, means2d_offset=None) -> dict:
    """The port's `render()` output keys the trainers read: rendered_image
    [H, W, 3], rendered_depth, rendered_alpha, radii, visibility_filter;
    `means2d_offset` as in the port (its gradient is dL/dpixel * 0.5*[W, H])."""
    splats = preprocess(means3d, scaling, rotation, opacity, shs, sh_degree,
                        camera, width, height, alive=alive)
    if means2d_offset is not None:
        scale = torch.tensor([[0.5 * width], [0.5 * height]],
                             dtype=torch.float32, device=means3d.device)
        splats = splats._replace(mean2d=splats.mean2d + means2d_offset * scale)
    b = bin_splats(splats, width, height)
    rows = torch.cat([splats.mean2d, splats.conic, splats.opacity[None],
                      splats.rgb, splats.depth[None]], dim=0)
    img = _Composite.apply(rows, b, width, height)
    return {"rendered_image": img[:, :, 0:3], "rendered_depth": img[:, :, 3],
            "rendered_alpha": img[:, :, 7], "radii": splats.radius,
            "visibility_filter": splats.radius > 0, "splats": splats,
            "binning": b}
