"""Exact-compaction fragment binning, the expand and segsum kernels, and the
differentiable `composite_compact`. Port of `rodygs_tpu/render/compact.py`.

The index structure is the JAX package's: fragments are enumerated
gaussian-major (slot m ascending, k = 0..cnt(m)-1 inside each gaussian) and
every capacity slot emits at least one fragment, so the fragment->gaussian
map m(i) is monotone with steps <= 1. `build_binning` (plain torch) derives
per-tile counts and ranges, per-512-slot window bases and the packed aux
rows from that invariant. The forward then runs

    expand (CUDA kernel) -> stable sort of the int32 key -> tile forward

and the backward

    tile backward -> inverse-permutation unsort -> segsum (CUDA kernel).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and uses the
plain PyTorch version beside it only for CPU tensors; there is no fallback.
expand writes a key for every slot but records only for the slots that
carry a fragment (`expand_fragments`); segsum writes every output element
itself, so neither wrapper fills anything beforehand.

Sort bands (`build_binning(bands > 1)`) split the structure into
contiguous tile-row ranges, each with its own gaussian-major enumeration
over `cap_band` slots: expand, the sort, the unsort and segsum then run
once per band, and the sorted blocks concatenate into the one records
array the tile kernels walk. Per-tile fragment sets and their depth order
are those of one band.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..utils.profiling import span
from .binning import TILE, _clip_i32, tile_rect
from .preprocess import Splats2D

FCHUNK = 512              # fragments per expand chunk (one bases[] entry)
WIN = FCHUNK + 128        # gaussian window per chunk (monotone map bound)
NUM_REC_ROWS = 13         # mx,my,ca,cb,cc,op,r,g,b,depth,nx,ny,nz
ROW_BASE_TILE = NUM_REC_ROWS
ROW_DBITS = NUM_REC_ROWS + 1
ROW_OFF = NUM_REC_ROWS + 2
ROW_SPANW = NUM_REC_ROWS + 3
ROW_SPAN_MAX = 8
ROW_RMODE = NUM_REC_ROWS + 4
ROW_ROWOFF0 = NUM_REC_ROWS + 5
ROW_TXLO0 = NUM_REC_ROWS + 5 + ROW_SPAN_MAX
N_CORE_ROWS = 10          # record rows [0:10): geometry + rgb + depth
NUM_FIELDS = 16           # tile-kernel record rows


def table_rows_for(aux_height: int) -> int:
    """Table height for an aux-row block height (8-aligned, as in JAX)."""
    return -(-(NUM_REC_ROWS + aux_height) // 8) * 8


NUM_TABLE_ROWS = table_rows_for(4)
NUM_TABLE_ROWS_RMODE = table_rows_for(5 + 2 * ROW_SPAN_MAX)
_OFF_PAD = 2.0e7          # > any valid off (C < 2^24)
INT32_MAX = 2**31 - 1

FRAGMENT_PROFILES = {"lean": 6, "wide": 12, "huge": 24}
PROFILE_LADDER = ("lean", "wide", "huge")
MAX_FRAGMENT_CAPACITY = (1 << 24) - FCHUNK
CAP_GRID_STEP = 1.25
_BAND_MIN_EXTENT = 1_200_000
BAND_KEEP_MARGIN = 1.03
BAND_UPGRADE_MARGIN = 1.10


# --------------------------------------------------------------------------
# capacity / profile helpers (host-side Python, identical logic to JAX)
# --------------------------------------------------------------------------


def next_profile(profile: str) -> str | None:
    """Next-wider fragment profile, or None at the top of the ladder."""
    i = PROFILE_LADDER.index(profile)
    return PROFILE_LADDER[i + 1] if i + 1 < len(PROFILE_LADDER) else None


def split_profile(profile):
    """(capacity_profile, bands) from a fragment-profile knob."""
    if isinstance(profile, (tuple, list)):
        return profile[0], int(profile[1])
    return profile, 1


def join_profile(profile, bands: int):
    """Inverse of split_profile."""
    return profile if bands <= 1 else (profile, int(bands))


def bands_viable(n: int, capacity: int, demand: int, bands: int,
                 margin: float = BAND_KEEP_MARGIN) -> bool:
    if bands <= 1:
        return True
    return (capacity // bands >= _BAND_MIN_EXTENT
            and bands * n + int(margin * demand) <= capacity)


def bands_decision(n: int, capacity: int, demand: int,
                   margin: float = BAND_UPGRADE_MARGIN) -> int:
    best = 1
    for b in (2, 3, 4):
        if bands_viable(n, capacity, demand, b, margin):
            best = b
    return best


def profile_for_demand(n: int, demand: int, current: str | int = "lean",
                       bands: int = 1):
    """Smallest ladder profile covering 1.15x demand (plus the banded
    structural floor), or an explicit capacity on the CAP_GRID_STEP grid
    beyond the ladder; None when no growth is possible."""
    cur_cap = fragment_capacity(n, current)
    want = (bands - 1) * n + int(demand * 1.15)
    for p in PROFILE_LADDER:
        cap = fragment_capacity(n, p)
        if cap >= want:
            return p if cap > cur_cap else None
    cap = max(fragment_capacity(n, PROFILE_LADDER[-1]), cur_cap)
    while cap < want and cap < MAX_FRAGMENT_CAPACITY:
        cap = min(int(cap * CAP_GRID_STEP), MAX_FRAGMENT_CAPACITY)
    cap = min(-(-cap // FCHUNK) * FCHUNK, MAX_FRAGMENT_CAPACITY)
    return cap if cap > cur_cap else None


def fit_capacity(n: int, demand: int, bands: int = 1) -> int:
    """Smallest grid capacity covering the structural floor (bands * n)
    plus 1.25x the observed demand."""
    want = max(bands * n + int(demand * 1.25), FCHUNK)
    cap = FCHUNK
    while cap < want:
        cap = -(-int(cap * CAP_GRID_STEP) // FCHUNK) * FCHUNK
    return min(cap, MAX_FRAGMENT_CAPACITY)


def escalation_poll_due(iteration: int) -> bool:
    """Poll every 5 iterations early, every 25 in steady state."""
    return iteration % (5 if iteration <= 100 else 25) == 0


def fragment_capacity(n: int, profile) -> int:
    """Capacity for a ladder name, an explicit integer, or a (profile,
    bands) tuple; FCHUNK-rounded and clamped to the f32-exact maximum."""
    profile, _ = split_profile(profile)
    if isinstance(profile, str):
        c = FRAGMENT_PROFILES[profile] * n
        c = -(-c // FCHUNK) * FCHUNK
        if c >= 1 << 24:
            raise ValueError("fragment capacity must stay below 2^24 "
                             "(f32-exact fragment indices)")
        return c
    c = -(-int(profile) // FCHUNK) * FCHUNK
    return max(FCHUNK, min(c, MAX_FRAGMENT_CAPACITY))


def padded_width(n: int) -> int:
    """Table width: n padded so any 128-aligned WIN-column window fits."""
    return -(-n // 128) * 128 + WIN


def tile_bits(tiles_x: int, tiles_y: int) -> int:
    return max(1, math.ceil(math.log2(tiles_x * tiles_y + 1)))


def depth_key_bits(tiles_x: int, tiles_y: int) -> int:
    return min(32 - tile_bits(tiles_x, tiles_y), 23)


def quantize_depth_bits(depth: torch.Tensor, db: int) -> torch.Tensor:
    """Top `db` bits of the f32 pattern (logical shift; int64 result)."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (31 - db)


# --------------------------------------------------------------------------
# rectangles and row spans
# --------------------------------------------------------------------------


def tight_tile_rect(mean2d, ext, tiles_x: int, tiles_y: int):
    """Tile rect of the alpha>=1/255 ellipse AABB (ext: [2, N] half-extents)."""
    px, py = mean2d[0], mean2d[1]
    ex, ey = ext[0], ext[1]
    xmin = _clip_i32(torch.floor(torch.ceil(px - ex) / TILE), tiles_x)
    ymin = _clip_i32(torch.floor(torch.ceil(py - ey) / TILE), tiles_y)
    xmax = _clip_i32(torch.floor(torch.floor(px + ex) / TILE) + 1, tiles_x)
    ymax = _clip_i32(torch.floor(torch.floor(py + ey) / TILE) + 1, tiles_y)
    return xmin, ymin, xmax, ymax


def ellipse_row_spans(mean2d, conic, t_cut, xmin, ymin, xmax, ymax,
                      tiles_x: int):
    """Exact per-tile-row x tile ranges of the alpha>=1/255 ellipse for the
    first ROW_SPAN_MAX rows of each gaussian's rect (see the JAX docstring
    for the closed form). Returns (txlo, span): [R, N] int32."""
    px, py = mean2d[0], mean2d[1]
    A, B, C = conic[0], conic[1], conic[2]
    det = torch.clamp(A * C - B * B, min=1e-30)
    dy_ext = torch.sqrt(torch.clamp(t_cut * A / det, min=0.0)) * 1.00001 + 1e-3
    dy_crit = B * torch.sqrt(torch.clamp(t_cut / (det * C), min=0.0))
    inv_a = 1.0 / A

    def upper(dy):
        rad = torch.clamp(t_cut * A - det * dy * dy, min=0.0)
        return (-B * dy + torch.sqrt(rad)) * inv_a

    def lower(dy):
        rad = torch.clamp(t_cut * A - det * dy * dy, min=0.0)
        return (-B * dy - torch.sqrt(rad)) * inv_a

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    txlos, spans = [], []
    for j in range(ROW_SPAN_MAX):
        row_lo = (ymin + j).to(torch.float32) * TILE - py
        row_hi = row_lo + (TILE - 1)
        bl = clip(row_lo, -dy_ext, dy_ext)
        bh = clip(row_hi, -dy_ext, dy_ext)
        nonempty = ((j < (ymax - ymin)) & (row_lo <= dy_ext)
                    & (row_hi >= -dy_ext))
        xhi = torch.maximum(torch.maximum(upper(bl), upper(bh)),
                            upper(clip(-dy_crit, bl, bh)))
        xlo = torch.minimum(torch.minimum(lower(bl), lower(bh)),
                            lower(clip(dy_crit, bl, bh)))
        xhi = xhi + (0.01 + 1e-5 * torch.abs(xhi))
        xlo = xlo - (0.01 + 1e-5 * torch.abs(xlo))
        tx_lo = torch.floor(torch.ceil(px + xlo) / TILE)
        tx_hi = torch.floor(torch.floor(px + xhi) / TILE) + 1.0
        tx_lo = torch.maximum(_clip_i32(tx_lo, tiles_x), xmin)
        tx_hi = torch.minimum(_clip_i32(tx_hi, tiles_x), xmax)
        span = torch.where(nonempty, torch.clamp(tx_hi - tx_lo, min=0), 0)
        txlos.append(torch.where(span > 0, tx_lo, 0))
        spans.append(span)
    return (torch.stack(txlos).to(torch.int32),
            torch.stack(spans).to(torch.int32))


# --------------------------------------------------------------------------
# build_binning
# --------------------------------------------------------------------------


class CompactBinning(NamedTuple):
    """Index structure for one render (all non-differentiable). With sort
    bands, aux_rows, bases and f_kept gain a leading band dimension B and
    bases cover cap_band = C/B (rounded up to FCHUNK) slots each."""

    aux_rows: torch.Tensor     # [(B,) 4 (or 21, rows mode), Nw] f32
    bases: torch.Tensor        # [(B,) Cb/FCHUNK] i32 128-aligned window starts
    tile_starts: torch.Tensor  # [T] i32 (band b's offset by b * cap_band)
    tile_counts: torch.Tensor  # [T] i32
    f_kept: torch.Tensor       # [(B,)] i32 fragments actually emitted
    num_fragments: torch.Tensor  # [] i32 true demand (may exceed capacity)
    dropped: torch.Tensor      # [] i32 fragments dropped by the clamp
    overflow: torch.Tensor     # [] bool


def build_table(rec13: torch.Tensor, aux_rows: torch.Tensor) -> torch.Tensor:
    """Pack differentiable record rows [13, Nw] + detached aux rows into the
    8-aligned expand table (zero pad rows)."""
    nw = aux_rows.shape[1]
    rows = table_rows_for(aux_rows.shape[0])
    pad = torch.zeros((rows - NUM_REC_ROWS - aux_rows.shape[0], nw),
                      dtype=torch.float32, device=aux_rows.device)
    return torch.cat([rec13, aux_rows.detach(), pad], dim=0)


def _rect_corners(sel, y0, y1, x0, x1, ys, xs):
    """Signed corner outer product [Ty+1, Tx+1] of the selected rects."""
    s = sel[:, None]
    a = ((s & (y0[:, None] == ys[None, :])).float()
         - (s & (y1[:, None] == ys[None, :])).float())
    b = ((s & (x0[:, None] == xs[None, :])).float()
         - (s & (x1[:, None] == xs[None, :])).float())
    return a.T @ b


def band_cap(capacity: int, bands: int) -> int:
    """Slots per band: capacity / bands, rounded up twice (to a slot, then
    to FCHUNK), as the JAX package rounds it."""
    return -(-(-(-capacity // bands)) // FCHUNK) * FCHUNK


@torch.no_grad()
def build_binning(
    splats: Splats2D,
    tiles_x: int,
    tiles_y: int,
    capacity: int,
    tight: bool | str = False,
    bands: int = 1,
) -> CompactBinning:
    """Compact fragment index structure (no gradients).

    tight=True intersects each rect with the alpha-cut ellipse AABB;
    tight="rows" also enumerates exact per-tile-row spans for gaussians at
    most ROW_SPAN_MAX rows tall. Per-tile counts are exact integers from a
    signed rect-corner product and a 2-D prefix sum, as in the JAX package.

    bands > 1 splits the structure into `bands` contiguous tile-row ranges
    whose boundaries balance the real fragment counts of an exact per-row
    histogram; band b enumerates its own fragments gaussian-major over
    `band_cap(capacity, bands)` slots from column b * cap_band. Returns
    aux_rows [B, A, Nw], bases [B, Cb/FCHUNK] and f_kept [B].
    """
    rows_mode = tight == "rows"
    mean2d = splats.mean2d.detach()
    depth = splats.depth.detach()
    dev = mean2d.device
    n = mean2d.shape[1]
    nw = padded_width(n)
    num_tiles = tiles_x * tiles_y
    db = depth_key_bits(tiles_x, tiles_y)

    xmin, ymin, xmax, ymax = tile_rect(mean2d, splats.radius, tiles_x, tiles_y)
    if tight:
        txmin, tymin, txmax, tymax = tight_tile_rect(
            mean2d, splats.ext.detach(), tiles_x, tiles_y)
        xmin = torch.maximum(xmin, txmin)
        ymin = torch.maximum(ymin, tymin)
        xmax = torch.minimum(xmax, txmax)
        ymax = torch.minimum(ymax, tymax)
    span_w = xmax - xmin
    span_h = ymax - ymin
    vis = splats.visible & (span_w > 0) & (span_h > 0)

    if rows_mode:
        opac = splats.opacity.detach()
        t_cut = torch.clamp(
            2.0 * torch.log(255.0 * torch.clamp(opac, min=1e-12)), min=0.0)
        row_txlo, row_span = ellipse_row_spans(
            mean2d, splats.conic.detach(), t_cut, xmin, ymin, xmax, ymax,
            tiles_x)
        rmode = vis & (span_h <= ROW_SPAN_MAX)
        rect_enum = vis & ~rmode
    else:
        rmode = torch.zeros((n,), dtype=torch.bool, device=dev)
        rect_enum = vis

    bands = max(1, min(int(bands), tiles_y))
    cap_band = band_cap(capacity, bands)
    ys = torch.arange(tiles_y + 1, dtype=torch.int32, device=dev)
    xs = torch.arange(tiles_x + 1, dtype=torch.int32, device=dev)
    dbits = torch.where(vis, quantize_depth_bits(depth, db), 0).to(torch.float32)
    zero = torch.zeros_like(span_w)

    def band(lo, hi, start_col: int, cap_b: int):
        """Tile rows [lo, hi) enumerated over cap_b slots whose records
        start at column start_col; bands = 1 is the band (0, tiles_y)."""
        bymin = torch.clamp(ymin, lo, hi)
        bymax = torch.clamp(ymax, lo, hi)
        bspan_h = bymax - bymin
        if rows_mode:
            # absolute row ymin + j lies in the band, or its span counts 0
            row_span_b = torch.stack([
                torch.where((ymin + j >= lo) & (ymin + j < hi), row_span[j],
                            0) for j in range(ROW_SPAN_MAX)])
            cnt_true = torch.where(
                rmode, row_span_b.sum(dim=0, dtype=torch.int32),
                torch.where(rect_enum, span_w * bspan_h, zero))
        else:
            cnt_true = torch.where(rect_enum, span_w * bspan_h, zero)
        cnt = torch.clamp(cnt_true, min=1).to(torch.int64)
        off_next = torch.cumsum(cnt, dim=0)
        off = off_next - cnt
        f_all = off_next[-1]

        kept = off_next <= cap_b
        f_kept = torch.sum(torch.where(kept, cnt, 0)).to(torch.int32)
        dropped = torch.sum(torch.where(kept, 0, cnt_true.to(torch.int64)))
        overflow = f_all > cap_b
        f_real = torch.sum(cnt_true.to(torch.int64))

        counted = rect_enum & kept
        corners = _rect_corners(counted, bymin, bymax, xmin, xmax, ys, xs)
        if rows_mode:
            row_kept = rmode & kept
            for j in range(ROW_SPAN_MAX):
                sel = row_kept & (row_span_b[j] > 0)
                corners = corners + _rect_corners(
                    sel, ymin + j, ymin + j + 1, row_txlo[j],
                    row_txlo[j] + row_span_b[j], ys, xs)
        counts2d = torch.cumsum(torch.cumsum(corners, dim=0), dim=1)
        tile_counts = torch.round(
            counts2d[:tiles_y, :tiles_x].reshape(-1)).to(torch.int32)
        tile_starts = (torch.cumsum(tile_counts, dim=0, dtype=torch.int32)
                       - tile_counts + start_col)

        chunk_q = torch.arange(cap_b // FCHUNK, dtype=torch.int64,
                               device=dev) * FCHUNK
        first_g = torch.searchsorted(off_next, chunk_q, right=True)
        bases = torch.clamp((first_g // 128) * 128, 0, nw - WIN).to(torch.int32)

        rvalid = rmode & (cnt_true > 0)
        base_tile = torch.where(
            rvalid, (ymin * tiles_x).to(torch.float32),
            torch.where(vis & (bspan_h > 0),
                        (bymin * tiles_x + xmin).to(torch.float32),
                        float(num_tiles)))
        parts = [
            base_tile[None],
            dbits[None],
            off.to(torch.float32)[None],
            torch.where(counted & (bspan_h > 0), span_w, 0).to(torch.float32)[None],
        ]
        if rows_mode:
            parts.append(rvalid.to(torch.float32)[None])
            row_prefix = torch.cumsum(row_span_b, dim=0) - row_span_b
            parts.append(row_prefix.to(torch.float32))
            parts.append(row_txlo.to(torch.float32))
        aux = torch.cat(parts, dim=0)
        aux_rows = torch.zeros((aux.shape[0], nw), dtype=torch.float32,
                               device=dev)
        aux_rows[:, :n] = aux
        # pad columns: off stays monotone and huge so no window search
        # finds them
        aux_rows[2, n:] = torch.arange(nw - n, dtype=torch.float32,
                                       device=dev) + _OFF_PAD
        return (aux_rows, bases, tile_starts, tile_counts, f_kept, f_real,
                dropped, overflow)

    if bands == 1:
        (aux_rows, bases, tile_starts, tile_counts, f_kept, f_real, dropped,
         overflow) = band(0, tiles_y, 0, capacity)
        return CompactBinning(
            aux_rows=aux_rows, bases=bases, tile_starts=tile_starts,
            tile_counts=tile_counts, f_kept=f_kept,
            num_fragments=f_real.to(torch.int32),
            dropped=dropped.to(torch.int32), overflow=overflow)

    # band boundaries from the per-tile-row histogram of real fragments:
    # rect gaussians add span_w to rows [ymin, ymax), rows-mode gaussians
    # row_span[j] to row ymin + j (before the clamp; balance is a heuristic).
    # Integer sums, below 2^24, so equal to the JAX package's f32 sums.
    def wsum_at(w, idx):
        out = torch.zeros((tiles_y + 1,), dtype=torch.int64, device=dev)
        return out.index_add_(0, idx.to(torch.int64), w.to(torch.int64))

    w_rect = torch.where(rect_enum, span_w, 0)
    row_counts = torch.cumsum(wsum_at(w_rect, ymin) - wsum_at(w_rect, ymax),
                              dim=0)[:tiles_y]
    if rows_mode:
        for j in range(ROW_SPAN_MAX):
            row_counts = row_counts + wsum_at(
                torch.where(rmode, row_span[j], 0),
                torch.clamp(ymin + j, max=tiles_y))[:tiles_y]
    cum = torch.cumsum(row_counts, dim=0).to(torch.float32)        # [Ty]
    targets = (torch.arange(1, bands, dtype=torch.float32, device=dev)
               * cum[-1] / float(bands))                           # [B-1]
    # boundary b = 1 + the last row whose cumulative count is below target
    his_inner = torch.clamp(
        (cum[None, :] < targets[:, None]).sum(dim=1) + 1, max=tiles_y)
    los = torch.cat([his_inner.new_zeros(1), his_inner])
    his = torch.cat([his_inner, his_inner.new_full((1,), tiles_y)])

    outs = [band(los[b], his[b], b * cap_band, cap_band) for b in range(bands)]
    # per-band counts are 0 outside the band's rows: the global counts are
    # their sum, the starts the owning band's (already column-offset)
    tile_row = torch.arange(num_tiles, dtype=torch.int32, device=dev) // tiles_x
    tile_counts = outs[0][3]
    tile_starts = outs[0][2]
    for b in range(1, bands):
        tile_counts = tile_counts + outs[b][3]
        in_band = (tile_row >= los[b]) & (tile_row < his[b])
        tile_starts = torch.where(in_band, outs[b][2], tile_starts)
    return CompactBinning(
        aux_rows=torch.stack([o[0] for o in outs]),
        bases=torch.stack([o[1] for o in outs]),
        tile_starts=tile_starts.to(torch.int32),
        tile_counts=tile_counts.to(torch.int32),
        f_kept=torch.stack([o[4] for o in outs]),
        num_fragments=sum(o[5] for o in outs).to(torch.int32),
        dropped=sum(o[6] for o in outs).to(torch.int32),
        overflow=torch.stack([o[7] for o in outs]).any())


# --------------------------------------------------------------------------
# expand: table -> (sort key, presort record rows)
# --------------------------------------------------------------------------


def expand_fragments_plain(table: torch.Tensor, bases: torch.Tensor,
                           f_kept: torch.Tensor, tiles_x: int, db: int,
                           n_rows: int = NUM_REC_ROWS):
    """Plain PyTorch version of the expand kernel (same function). It
    writes every slot's records: a slot without an owner gets zeros, a slot
    at or past f_kept its window owner's rows."""
    dev = table.device
    capacity = bases.shape[0] * FCHUNK
    i = torch.arange(capacity, dtype=torch.int64, device=dev)
    base = bases.to(torch.int64)[i // FCHUNK]
    off = table[ROW_OFF].contiguous()
    # the off row increases over the whole table, so the last window column
    # with off <= i is the global search result clamped into the window
    w = torch.searchsorted(off, i.to(torch.float32), right=True) - 1 - base
    none = w < 0
    g = base + torch.clamp(w, 0, WIN - 1)
    cols = table[:, g]                                    # [R, C]

    k = i - cols[ROW_OFF].to(torch.int64)
    span_w = cols[ROW_SPANW].to(torch.int64)
    ky = torch.div(k, torch.clamp(span_w, min=1), rounding_mode="floor")
    kx = k - ky * torch.clamp(span_w, min=1)
    base_tile = cols[ROW_BASE_TILE].to(torch.int64)
    tile = base_tile + ky * tiles_x + kx
    valid = span_w > 0
    if table.shape[0] >= NUM_TABLE_ROWS_RMODE:
        use_rows = cols[ROW_RMODE] > 0.5
        rowoff = cols[ROW_ROWOFF0:ROW_ROWOFF0 + ROW_SPAN_MAX].to(torch.int64)
        txlo = cols[ROW_TXLO0:ROW_TXLO0 + ROW_SPAN_MAX].to(torch.int64)
        r = (rowoff <= k[None]).sum(dim=0) - 1
        rc = torch.clamp(r, min=0)[None]
        has = r >= 0
        rowoff_r = torch.where(has, rowoff.gather(0, rc)[0], 0)
        txlo_r = torch.where(has, txlo.gather(0, rc)[0], 0)
        tile_rows = base_tile + r * tiles_x + txlo_r + (k - rowoff_r)
        tile = torch.where(use_rows, tile_rows, tile)
        valid = valid | use_rows
    valid = valid & (i < f_kept.to(torch.int64)) & ~none
    dbits = cols[ROW_DBITS].to(torch.int64)
    packed = ((((tile & 0xFFFFFFFF) << db) & 0xFFFFFFFF) | dbits) ^ 0x80000000
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    key = torch.where(valid, packed, INT32_MAX).to(torch.int32)
    rec = torch.where(none[None], 0.0, cols[:n_rows])
    return key, rec


def expand_fragments(table: torch.Tensor, bases: torch.Tensor,
                     f_kept: torch.Tensor, tiles_x: int, db: int,
                     n_rows: int = NUM_REC_ROWS,
                     rec_out: torch.Tensor | None = None):
    """table [24 or 40, Nw] f32, bases [C/512] i32, f_kept [] i32 ->
    (key [C] i32 in biased-u32 order, rec [n_rows, C] presort records),
    n_rows = NUM_REC_ROWS (13) or N_CORE_ROWS (10, without the normals).

    The key is exact in every slot: INT32_MAX where the slot carries no
    fragment. The record of slot i is written only where i < f_kept and the
    slot has an owner in its chunk's window; every other record column is
    left as it was (uninitialised memory, or `rec_out` where the caller
    hands the buffer in). Such slots sort behind every tile range and no
    kernel reads their records.

    Launches the CUDA expand kernel for CUDA tensors; the plain version
    serves CPU tensors only."""
    if n_rows not in (N_CORE_ROWS, NUM_REC_ROWS):
        raise ValueError(f"expand emits {N_CORE_ROWS} or {NUM_REC_ROWS} "
                         f"record rows, not {n_rows}")
    capacity = bases.shape[0] * FCHUNK
    if not table.is_cuda:
        key, rec = expand_fragments_plain(table, bases, f_kept, tiles_x, db,
                                          n_rows)
        if rec_out is not None:
            filled = torch.arange(capacity) < f_kept
            rec = torch.where(filled[None], rec, rec_out)
        return key, rec
    table = table.detach().contiguous()
    kernels.check_cuda(table, "expand table", torch.float32, 2)
    kernels.check_cuda(bases, "expand bases", torch.int32, 1)
    f_kept = f_kept.reshape(1).to(torch.int32).contiguous()
    key = torch.empty((capacity,), dtype=torch.int32, device=table.device)
    rec = rec_out
    if rec is None:
        rec = torch.empty((n_rows, capacity), dtype=torch.float32,
                          device=table.device)
    kernels.check_cuda(rec, "expand records", torch.float32, 2)
    if rec.shape != (n_rows, capacity):
        raise ValueError(f"expand records: expected {(n_rows, capacity)}, "
                         f"got {tuple(rec.shape)}")
    kernels.launch("expand", table, table.shape[1], bases, bases.shape[0],
                   f_kept, tiles_x, db,
                   int(table.shape[0] >= NUM_TABLE_ROWS_RMODE), n_rows, key,
                   rec)
    return key, rec


# --------------------------------------------------------------------------
# segsum: presort-order gradient rows -> per-gaussian rows
# --------------------------------------------------------------------------


def segment_sum_rows_plain(d_presort: torch.Tensor, table: torch.Tensor,
                           f_kept: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the segsum kernel: out[r, g] sums
    d_presort[r, i] over gaussian g's slot range [off[g], off[g+1])
    clamped to [0, f_kept), in float32 and in slot order from 0, as the
    kernel sums a range of up to 32 slots (and as the legacy path's
    `index_add_` sums on the CPU). Nothing past f_kept is read."""
    n_rows, c = d_presort.shape
    dev = d_presort.device
    end = torch.clamp(f_kept.to(torch.int64), max=c)
    off = table[ROW_OFF].detach().to(torch.int64)
    lo = torch.minimum(off, end)
    hi = torch.minimum(torch.cat([off[1:], end.reshape(1)]), end)
    cnt = hi - lo
    out = torch.zeros((n_rows, off.shape[0]), dtype=torch.float32, device=dev)
    # the ranges longest first: the ranges still open at step k are a prefix
    order = torch.argsort(cnt, descending=True)
    cnt_s, lo_s = cnt[order], lo[order]
    n_live = int((cnt_s > 0).sum())
    if n_live == 0:
        return out
    steps = torch.arange(int(cnt_s[0]), device=dev)
    open_at = n_live - torch.searchsorted(cnt_s[:n_live].flip(0), steps,
                                          right=True)
    acc = torch.zeros((n_rows, n_live), dtype=torch.float32, device=dev)
    for k, m in enumerate(open_at.tolist()):
        acc[:, :m] += d_presort[:, lo_s[:m] + k]
    out[:, order[:n_live]] = acc
    return out


def segment_sum_rows(d_presort: torch.Tensor, table: torch.Tensor,
                     bases: torch.Tensor, f_kept: torch.Tensor
                     ) -> torch.Tensor:
    """d_presort [n_rows, C] f32 (presort order); table: the expand table
    (only its offsets row is read); bases [C/512] i32: the chunk windows of
    the same binning -> [n_rows, Nw], every element written (zeros for
    gaussians without a filled slot and for pad columns). Nothing at or
    past f_kept is read. Launches the CUDA segsum kernel for CUDA tensors
    (n_rows 10 or 13); the plain version serves CPU tensors only."""
    if not d_presort.is_cuda:
        return segment_sum_rows_plain(d_presort, table, f_kept)
    d_presort = d_presort.contiguous()
    kernels.check_cuda(d_presort, "segsum rows", torch.float32, 2)
    kernels.check_cuda(bases, "segsum bases", torch.int32, 1)
    n_rows, c = d_presort.shape
    if n_rows not in (N_CORE_ROWS, NUM_REC_ROWS):
        raise ValueError(f"segsum sums {N_CORE_ROWS} or {NUM_REC_ROWS} rows, "
                         f"not {n_rows}")
    if c != bases.shape[0] * FCHUNK:
        raise ValueError(f"segsum: {c} slots for {bases.shape[0]} chunks")
    off_row = table[ROW_OFF].detach().contiguous()
    f_kept = f_kept.reshape(1).to(torch.int32).contiguous()
    nw = off_row.shape[0]
    out = torch.empty((n_rows, nw), dtype=torch.float32,
                      device=d_presort.device)
    kernels.launch("segsum", d_presort, n_rows, c, off_row, nw, bases, f_kept,
                   out)
    return out


# --------------------------------------------------------------------------
# composite_compact: expand -> sort -> tile forward; backward tile backward
# -> unsort -> segsum
# --------------------------------------------------------------------------


def sort_fragments(key: torch.Tensor, rec: torch.Tensor):
    """Stable sort by the int32 key; the record rows are gathered by the
    returned permutation (bit-identical to carrying them through the sort).
    Returns (presort index [C] i64, sorted rows)."""
    _, perm = torch.sort(key, stable=True)
    return perm, rec[:, perm]


def stack_records(rows: torch.Tensor) -> torch.Tensor:
    """Sorted rows [13 or 10, C] -> the [16, C] tile-kernel record layout
    (normal rows zero when skipped; row 13 the constant alpha feature)."""
    c = rows.shape[1]
    parts = [rows]
    if rows.shape[0] == N_CORE_ROWS:
        parts.append(rows.new_zeros((NUM_REC_ROWS - N_CORE_ROWS, c)))
    parts += [rows.new_ones((1, c)), rows.new_zeros((2, c))]
    return torch.cat(parts, dim=0).contiguous()


class _CompositeCompact(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, bases, f_kept, tile_starts, tile_counts,
                tile_id_offset, tiles_x, tiles_y, include_normal, bands):
        from .tile_kernel import rasterize_fwd_impl

        db = depth_key_bits(tiles_x, tiles_y)
        n_rows = NUM_REC_ROWS if include_normal else N_CORE_ROWS
        banded = bands > 1
        tables = list(table) if banded else [table]
        bases_b = list(bases) if banded else [bases]
        f_kept_b = list(f_kept) if banded else [f_kept]
        rows_parts, unsorts = [], []
        for tab, bs, fk in zip(tables, bases_b, f_kept_b):
            with span("expand"):
                key, rec = expand_fragments(tab, bs, fk, tiles_x, db, n_rows)
            with span("fragment_sort", device=True):
                perm, rows = sort_fragments(key, rec)
            rows_parts.append(rows)
            unsorts.append(perm)
        # band tile ids ascend with b: the concatenation is the sorted order
        records = stack_records(torch.cat(rows_parts, dim=1) if banded
                                else rows_parts[0])
        with span("tile_fwd"):
            out = rasterize_fwd_impl(records, tile_starts, tile_counts,
                                     tile_id_offset, tiles_x, include_normal)
        ctx.save_for_backward(records, tile_starts, tile_counts,
                              tile_id_offset, table.detach(), bases, f_kept,
                              out, *unsorts)
        ctx.tiles_x = tiles_x
        ctx.n_rows = n_rows
        ctx.banded = banded
        return out

    @staticmethod
    def backward(ctx, gout):
        from .tile_kernel import rasterize_bwd_impl

        (records, tile_starts, tile_counts, tile_id_offset, table, bases,
         f_kept, out, *unsorts) = ctx.saved_tensors
        with span("tile_bwd"):
            d_records = rasterize_bwd_impl(records, tile_starts, tile_counts,
                                           tile_id_offset, out,
                                           gout.contiguous(), ctx.tiles_x,
                                           ctx.n_rows == NUM_REC_ROWS)
        n_rows = ctx.n_rows
        tables = list(table) if ctx.banded else [table]
        bases_b = list(bases) if ctx.banded else [bases]
        f_kept_b = list(f_kept) if ctx.banded else [f_kept]
        cap_b = unsorts[0].shape[0]
        d_tables = []
        for b, (tab, bs, fk) in enumerate(zip(tables, bases_b, f_kept_b)):
            d_rec = d_records[:n_rows, b * cap_b:(b + 1) * cap_b]
            with span("fragment_unsort", device=True):
                # the exact inverse-permutation scatter (what the JAX
                # package's second sort on the presort index computes)
                d_presort = torch.empty_like(d_rec)
                d_presort[:, unsorts[b]] = d_rec
            with span("segsum"):
                d_rows = segment_sum_rows(d_presort, tab, bs, fk)
            d_tables.append(torch.cat(
                [d_rows, d_rows.new_zeros((tab.shape[0] - n_rows,
                                           d_rows.shape[1]))], dim=0))
        d_table = torch.stack(d_tables) if ctx.banded else d_tables[0]
        return (d_table,) + (None,) * 9


def composite_compact(table, bases, f_kept, tile_starts, tile_counts,
                      tile_id_offset, tiles_x: int, tiles_y: int,
                      include_normal: bool = True,
                      bands: int = 1) -> torch.Tensor:
    """Differentiable fragment compositing over the compact index structure.

    table [24 or 40, Nw]: rows 0..12 the differentiable record rows, the
    rest detached aux rows (build_table). Returns [T, 8, 256] tile planes.
    include_normal=False keeps the 3 normal rows out of the sort and the
    unsort (composited normal planes are 0, their table gradient rows 0).

    bands > 1 takes the banded structure of `build_binning(bands=B)`: table
    [B, R, Nw], bases [B, Cb/FCHUNK], f_kept [B]. Each band expands, sorts,
    unsorts and segment-sums on its own; the table's cotangent is
    [B, R, Nw], which the caller's stack of per-band tables sums.
    """
    if table.dim() != (3 if bands > 1 else 2):
        raise ValueError(f"bands={bands} with a table of shape "
                         f"{tuple(table.shape)}")
    return _CompositeCompact.apply(table, bases, f_kept, tile_starts,
                                   tile_counts, tile_id_offset, tiles_x,
                                   tiles_y, include_normal, bands)
