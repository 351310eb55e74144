"""Frozen copy of the plain tile compositors of
`rodygs_tpu_torch/render/tile_kernel.py` (`rasterize_fwd_plain`,
`rasterize_bwd_plain`, the whole-warp cull `warp_cull_keep_plain`) for the
benchmark's plain reference and its operation counts: later changes to the
program do not reach them.

Record rows (f32, field-major [16, P]):
  0:mx 1:my 2:conic_a 3:conic_b 4:conic_c 5:opacity
  6:r 7:g 8:b 9:depth 10:nx 11:ny 12:nz 13:const_one 14:pad 15:pad
Output channels are [r, g, b, depth, nx, ny, nz, alpha] as [T, 8, 256]
tile planes.

Blending: alpha = min(0.99, o*exp(-sigma)); fragments with sigma<0 or
alpha<1/255 are skipped; a pixel stops at the first fragment that would take
its transmittance below 1e-4 (compared in log space); the clamp has a zero
subgradient. The log transmittance and the prefix sums are carried lane by
lane, the association order of the port's CUDA kernels, so a pixel's stop
decision is taken on the same float value. Each tile's range is walked in
128-fragment chunks, vectorized over the tiles given.
"""

from __future__ import annotations

import math

import torch

TILE = 16
CHUNK = 128
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
