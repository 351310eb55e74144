"""Tile compositing, forward and analytic backward. Port of
`rodygs_tpu/render/tile_kernel.py` (`rasterize_fwd_impl`,
`rasterize_bwd_impl`, the legacy path's differentiable `rasterize_tiles` /
`rasterize_tiles_ranged`, `tiles_to_image`).

Record rows (f32, field-major [16, P]):
  0:mx 1:my 2:conic_a 3:conic_b 4:conic_c 5:opacity
  6:r 7:g 8:b 9:depth 10:nx 11:ny 12:nz 13:const_one 14:pad 15:pad
Rows 6..13 are the composited features; output channels are
[r, g, b, depth, nx, ny, nz, alpha] as [T, 8, 256] tile planes.

Blending: alpha = min(0.99, o*exp(-sigma)); fragments with sigma<0 or
alpha<1/255 are skipped; a pixel stops at the first fragment that would take
its transmittance below 1e-4 (compared in log space, as in the JAX kernel);
the clamp has a zero subgradient.

The plain versions below serve CPU tensors, and hold the kernels to account
on the card. They take the kernels' arithmetic in the kernels' order: the
log transmittance and the prefix sums are carried lane by lane (not by a
parallel scan), and the kernels take the conic form, alpha and the log transmittance with
explicitly rounded operations (no FMA contraction), so a pixel's stop
decision and every alpha threshold are taken on the same float values.
The weight is alpha * exp(log T before the fragment) here; the kernels carry
that transmittance as a running product, which no decision depends on.

The wrappers launch the CUDA kernels (csrc/tile_fwd.cu, csrc/tile_bwd.cu)
for CUDA tensors; the plain versions serve CPU tensors only. They walk each
tile's range in 128-fragment chunks, vectorized over all tiles at once.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .binning import CHUNK, TILE

NUM_CHANNELS = 8
NUM_FIELDS = 16
PIX = TILE * TILE
LOG_T_EPS = math.log(1e-4)
ALPHA_MAX = 0.99
ALPHA_EPS = 1.0 / 255.0
_FEAT0, _FEAT1 = 6, 14


def _pixel_coords(tile_id_offset: torch.Tensor, num_tiles: int, tiles_x: int):
    """[T, PIX] pixel coordinates; pixel p = py_local*16 + px_local."""
    dev = tile_id_offset.device
    tid = tile_id_offset.reshape(1).to(torch.int64) + torch.arange(
        num_tiles, device=dev)
    p = torch.arange(PIX, device=dev)
    px = ((tid % tiles_x) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((tid // tiles_x) * TILE)[:, None] + (p // TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _chunks(records, tile_starts, tile_counts):
    """Yield (column index [T, CHUNK], valid [T, CHUNK], rec [16, T, CHUNK])
    for each 128-fragment chunk of every tile's range. Lanes past a range
    read zeros, not their neighbours' columns: like the kernels, the plain
    versions take nothing from outside the tile ranges (columns that carry
    no fragment may hold anything)."""
    p_cols = records.shape[1]
    counts = tile_counts.to(torch.int64)
    max_count = int(counts.max()) if counts.numel() else 0
    lane = torch.arange(CHUNK, device=records.device)
    for c0 in range(0, max_count, CHUNK):
        k = c0 + lane[None, :]
        valid = k < counts[:, None]
        idx = torch.clamp(tile_starts.to(torch.int64)[:, None] + k, 0,
                          p_cols - 1)
        yield idx, valid, torch.where(valid[None], records[:, idx], 0.0)


def _chunk_alpha(rec, px, py, valid):
    """Per-chunk elementwise math over [T, PIX, CHUNK]: offsets, the
    Gaussian falloff g, o*g and the clamped, thresholded alpha."""
    dx = px[:, :, None] - rec[0][:, None, :]
    dy = py[:, :, None] - rec[1][:, None, :]
    ca, cb, cc = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    g = torch.exp(-sigma)
    unclamped = rec[5][:, None, :] * g
    alpha = torch.clamp(unclamped, max=ALPHA_MAX)
    keep = (sigma >= 0) & (alpha >= ALPHA_EPS) & valid[:, None, :]
    return dx, dy, g, unclamped, torch.where(keep, alpha, 0.0)


def _walk(alpha, log_t):
    """Front-to-back walk over a chunk's lanes with a carried [T, PIX] log
    transmittance, one lane at a time — the association order of the CUDA
    kernels, so each pixel's stop decision is taken on the same value.
    Returns (contrib, t_excl, w) over [T, PIX, CHUNK] and the new carry."""
    contrib, t_excl = [], []
    for k in range(alpha.shape[2]):
        lg = torch.log1p(-alpha[:, :, k])
        log_t_incl = log_t + lg
        contrib.append(log_t_incl >= LOG_T_EPS)
        t_excl.append(torch.exp(log_t))
        log_t = log_t_incl
    contrib = torch.stack(contrib, dim=2)
    t_excl = torch.stack(t_excl, dim=2)
    w = torch.where(contrib, alpha * t_excl, 0.0)
    return contrib, t_excl, w, log_t


def _live_channels(include_normal: bool) -> tuple[int, ...]:
    """Output channels that carry a feature row: all 8, or without the
    normal rows r, g, b, depth and alpha."""
    return tuple(range(NUM_CHANNELS)) if include_normal else (0, 1, 2, 3, 7)


def rasterize_fwd_plain(records, tile_starts, tile_counts, tile_id_offset,
                        tiles_x: int, include_normal: bool = True
                        ) -> torch.Tensor:
    """Plain PyTorch version of the tile-forward kernel. With
    include_normal=False the normal rows 10..12 are taken as zeros and the
    alpha feature (row 13) as one, neither is read: the same bits as the
    8-channel walk over such records."""
    num_tiles = tile_starts.shape[0]
    px, py = _pixel_coords(tile_id_offset, num_tiles, tiles_x)
    log_t = torch.zeros((num_tiles, PIX), device=records.device)
    acc = [torch.zeros((num_tiles, PIX), device=records.device)
           for _ in range(NUM_CHANNELS)]
    for _, valid, rec in _chunks(records, tile_starts, tile_counts):
        alpha = _chunk_alpha(rec, px, py, valid)[4]
        _, _, w, log_t = _walk(alpha, log_t)
        for k in range(w.shape[2]):
            for c in _live_channels(include_normal):
                if c == 7 and not include_normal:
                    acc[c] = acc[c] + w[:, :, k]
                else:
                    acc[c] = acc[c] + w[:, :, k] * rec[_FEAT0 + c][:, k, None]
    return torch.stack(acc, dim=1)


def rasterize_bwd_plain(records, tile_starts, tile_counts, tile_id_offset,
                        out, gout, tiles_x: int, include_normal: bool = True
                        ) -> torch.Tensor:
    """Plain PyTorch version of the tile-backward kernel: d_records [16, P].
    include_normal as in `rasterize_fwd_plain`; the gradient rows 10..12 of
    the dead normal rows are then not formed and read 0. Sums over channels run in channel order and each feature row's
    pixel sum is its own reduction, so leaving dead channels out changes no
    bit of the rest."""
    num_tiles = tile_starts.shape[0]
    live = _live_channels(include_normal)
    px, py = _pixel_coords(tile_id_offset, num_tiles, tiles_x)
    g_o = torch.zeros((num_tiles, PIX), device=records.device)
    for c in live:
        g_o = g_o + gout[:, c] * out[:, c]
    log_t = torch.zeros((num_tiles, PIX), device=records.device)
    prefu = torch.zeros((num_tiles, PIX), device=records.device)
    d_records = torch.zeros_like(records)
    for idx, valid, rec in _chunks(records, tile_starts, tile_counts):
        dx, dy, g, unclamped, alpha = _chunk_alpha(rec, px, py, valid)
        contrib, t_excl, w, log_t = _walk(alpha, log_t)
        fg = torch.zeros_like(w)
        for c in live:
            if c == 7 and not include_normal:
                fg = fg + gout[:, c, :, None]
            else:
                fg = fg + gout[:, c, :, None] * rec[_FEAT0 + c][:, None, :]
        u = w * fg
        prefix = []
        for k in range(u.shape[2]):
            prefu = prefu + u[:, :, k]
            prefix.append(prefu)
        suffix = g_o[:, :, None] - torch.stack(prefix, dim=2)
        d_alpha = torch.where(contrib & (alpha > 0),
                              t_excl * fg - suffix / (1.0 - alpha), 0.0)
        d_unc = torch.where(unclamped < ALPHA_MAX, d_alpha, 0.0)
        d_sigma = -unclamped * d_unc
        ca, cb, cc = rec[2][:, None, :], rec[3][:, None, :], rec[4][:, None, :]
        zero = torch.zeros_like(w[:, 0])
        vals = torch.stack([
            torch.sum(d_sigma * -(ca * dx + cb * dy), dim=1),
            torch.sum(d_sigma * -(cc * dy + cb * dx), dim=1),
            torch.sum(d_sigma * 0.5 * dx * dx, dim=1),
            torch.sum(d_sigma * dx * dy, dim=1),
            torch.sum(d_sigma * 0.5 * dy * dy, dim=1),
            torch.sum(g * d_unc, dim=1),
        ] + [torch.sum(gout[:, c, :, None] * w, dim=1) if c in live else zero
             for c in range(NUM_CHANNELS)])                # [14, T, K]
        d_records[:_FEAT1, idx[valid]] = vals[:, valid]
    return d_records


# Warp shapes of the tile kernels: (columns, rows) of the pixel rectangle
# of one warp. "block" is what the kernels use; "strip" what a thread index
# split as (tid % 16, tid / 16) gives, kept to count what the block saves.
WARP_SHAPES = {"block": (8, 4), "strip": (16, 2)}
NUM_WARPS = PIX // 32
CULL_ABS, CULL_REL, CULL_MIN_DET = 1e-2, 1e-5, 1e-5


def warp_of_pixel(shape: str) -> torch.Tensor:
    """[PIX] i64: the warp (0..7) whose rectangle holds pixel p."""
    w, h = WARP_SHAPES[shape]
    p = torch.arange(PIX)
    return (p // TILE // h) * (TILE // w) + (p % TILE) // w


def warp_cull_keep_plain(rec, tile_id_offset, tiles_x: int,
                         shape: str = "block") -> torch.Tensor:
    """Plain PyTorch twin of the kernels' whole-warp cull
    (csrc/tile_common.cuh::rect_may_take), same formula and margin.
    rec [>=6, T, K] are chunk records of T tiles; returns keep [T, 8, K]
    bool: False only where no pixel of the warp's rectangle can have
    sigma >= 0 and alpha >= 1/255."""
    num_tiles = rec.shape[1]
    dev = rec.device
    w, h = WARP_SHAPES[shape]
    tid = tile_id_offset.reshape(1).to(torch.int64) + torch.arange(
        num_tiles, device=dev)
    warp = torch.arange(NUM_WARPS, device=dev)
    x0 = ((tid % tiles_x) * TILE)[:, None] + (warp % (TILE // w) * w)[None, :]
    y0 = ((tid // tiles_x) * TILE)[:, None] + (warp // (TILE // w) * h)[None, :]
    x0 = x0.to(torch.float32)[:, :, None]
    y0 = y0.to(torch.float32)[:, :, None]
    mx, my, ca, cb, cc, op = (rec[i][:, None, :] for i in range(6))
    dx0, dx1 = x0 - mx, x0 + (w - 1) - mx
    dy0, dy1 = y0 - my, y0 + (h - 1) - my

    def form(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def clamp(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    ty0, tx0 = -cb / cc, -cb / ca
    smin = torch.minimum(
        torch.minimum(form(dx0, clamp(ty0 * dx0, dy0, dy1)),
                      form(dx1, clamp(ty0 * dx1, dy0, dy1))),
        torch.minimum(form(clamp(tx0 * dy0, dx0, dx1), dy0),
                      form(clamp(tx0 * dy1, dx0, dx1), dy1)))
    ex = torch.maximum(dx0.abs(), dx1.abs())
    ey = torch.maximum(dy0.abs(), dy1.abs())
    mag = 0.5 * (ca * ex * ex + cc * ey * ey) + cb.abs() * ex * ey
    convex = (ca > 0) & (cc > 0) & (ca * cc - cb * cb > CULL_MIN_DET * ca * cc)
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    far = smin > torch.log(255.0 * op) + CULL_ABS + CULL_REL * mag
    return ~(op < ALPHA_EPS) & (~convex | inside | ~far)


def _check_tile_args(records, tile_starts, tile_counts, tile_id_offset):
    kernels.check_cuda(records, "records", torch.float32, 2)
    if records.shape[0] != NUM_FIELDS:
        raise ValueError(f"records: expected {NUM_FIELDS} rows")
    kernels.check_cuda(tile_starts, "tile_starts", torch.int32, 1)
    kernels.check_cuda(tile_counts, "tile_counts", torch.int32, 1)
    kernels.check_cuda(tile_id_offset, "tile_id_offset", torch.int32, 1)


def rasterize_fwd_impl(records, tile_starts, tile_counts, tile_id_offset,
                       tiles_x: int, include_normal: bool = True
                       ) -> torch.Tensor:
    """records [16, P] f32 depth-sorted; tile_starts/counts [T] i32 (unaligned
    ranges); tile_id_offset [1] i32 global id of tile 0 -> [T, 8, 256] f32.
    include_normal=False promises zero normal rows and a unit alpha feature
    (what `compact.stack_records` makes of 10 sorted rows); they are not
    read."""
    if not records.is_cuda:
        return rasterize_fwd_plain(records, tile_starts, tile_counts,
                                   tile_id_offset, tiles_x, include_normal)
    _check_tile_args(records, tile_starts, tile_counts, tile_id_offset)
    num_tiles = tile_starts.shape[0]
    out = torch.empty((num_tiles, NUM_CHANNELS, PIX), dtype=torch.float32,
                      device=records.device)
    kernels.launch("tile_fwd", records, records.shape[1], tile_starts,
                   tile_counts, tile_id_offset, num_tiles, tiles_x,
                   int(include_normal), out)
    return out


def rasterize_bwd_impl(records, tile_starts, tile_counts, tile_id_offset,
                       out, gout, tiles_x: int, include_normal: bool = True
                       ) -> torch.Tensor:
    """d(loss)/d(records) [16, P] from the tile-plane cotangent `gout`.
    include_normal as in `rasterize_fwd_impl`; without it rows 10..12 of the
    result (the unread normal rows' gradients) are 0."""
    if not records.is_cuda:
        return rasterize_bwd_plain(records, tile_starts, tile_counts,
                                   tile_id_offset, out, gout, tiles_x,
                                   include_normal)
    _check_tile_args(records, tile_starts, tile_counts, tile_id_offset)
    kernels.check_cuda(out, "out", torch.float32, 3)
    kernels.check_cuda(gout, "gout", torch.float32, 3)
    d_records = torch.zeros_like(records)
    kernels.launch("tile_bwd", records, records.shape[1], tile_starts,
                   tile_counts, tile_id_offset, tile_starts.shape[0], tiles_x,
                   int(include_normal), out, gout, d_records)
    return d_records


class _RasterizeTiles(torch.autograd.Function):
    """The legacy path's compositor: forward `rasterize_fwd_impl`, backward
    `rasterize_bwd_impl` from the saved planes, all 8 channels live."""

    @staticmethod
    def forward(ctx, records, tile_starts, tile_counts, tile_id_offset,
                tiles_x):
        records = records.contiguous()
        out = rasterize_fwd_impl(records, tile_starts, tile_counts,
                                 tile_id_offset, tiles_x)
        ctx.save_for_backward(records, tile_starts, tile_counts,
                              tile_id_offset, out)
        ctx.tiles_x = tiles_x
        return out

    @staticmethod
    def backward(ctx, gout):
        records, tile_starts, tile_counts, tile_id_offset, out = \
            ctx.saved_tensors
        d_records = rasterize_bwd_impl(records, tile_starts, tile_counts,
                                       tile_id_offset, out, gout.contiguous(),
                                       ctx.tiles_x)
        return d_records, None, None, None, None


def rasterize_tiles_ranged(padded_records, tile_starts, tile_counts,
                           tile_id_offset, tiles_x: int) -> torch.Tensor:
    """`rasterize_tiles` with the [1] i32 global id of the first tile."""
    return _RasterizeTiles.apply(padded_records, tile_starts, tile_counts,
                                 tile_id_offset, tiles_x)


def rasterize_tiles(padded_records, tile_starts, tile_counts,
                    tiles_x: int) -> torch.Tensor:
    """Composite sorted fragment records into per-tile channel planes,
    differentiably in the records.

    padded_records [16, P] f32 field-major, depth-sorted (any P: the kernels
    read only the tile ranges); tile_starts / tile_counts [T] i32 unaligned
    ranges into it (binning.TileBinning). Returns [T, 8, 256] f32 planes."""
    return rasterize_tiles_ranged(
        padded_records, tile_starts, tile_counts,
        torch.zeros((1,), dtype=torch.int32, device=padded_records.device),
        tiles_x)


def tiles_to_image(tile_out: torch.Tensor, tiles_x: int, tiles_y: int,
                   image_width: int, image_height: int) -> torch.Tensor:
    """[T, 8, 256] per-tile planes -> [H, W, 8] channels-last image."""
    img = tile_out.reshape(tiles_y, tiles_x, NUM_CHANNELS, TILE, TILE)
    img = img.permute(0, 3, 1, 4, 2)  # ty, py, tx, px, c
    img = img.reshape(tiles_y * TILE, tiles_x * TILE, NUM_CHANNELS)
    return img[:image_height, :image_width]
