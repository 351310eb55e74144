"""Legacy tile binning: duplicate splats per touched tile, sort by (tile,
depth), per-tile ranges into the sorted order. Port of
`rodygs_tpu/render/binning.py`; `render(binning_mode="legacy")` runs it.

  * Two-tier broadcast expansion. Tier 1 emits a [K1, N] fragment grid
    (spans up to K1W x K1H tiles) by broadcasting each gaussian's rect
    against a k-iota; the gaussians whose rect exceeds it are compacted into
    the profile's larger tiers, N / fraction slots each. Spans beyond the
    last tier are clamped (right / bottom cut) and reported by `overflow`.
  * One stable two-key (tile, depth) sort over the flattened fragments;
    fragments of one (tile, depth) key stay in k-major tier order.
  * Tile ranges by counting (binary search on the sorted tile ids).
  * The sorted ids are padded to a CHUNK multiple plus one CHUNK with dummy
    ids N, N + 1, ... (round robin over DUMMY_COLS columns, which the
    renderer's record matrix holds as zeros), and so is every slot without a
    fragment: the gather's backward, a scatter-add, then meets no index
    millions of times.

All outputs are integer index structures, computed without gradients; the
renderer gathers per-gaussian records by `padded_gid`, and the backward of
that gather is the scatter-add (`index_add_`) that sums each gaussian's
fragment gradients. Plain torch throughout: index work outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16          # pixels per tile side
CHUNK = 128        # fragments per compositing chunk of the JAX kernels
# invalid fragments get round-robin dummy gaussian ids n .. n+DUMMY_COLS-1
DUMMY_COLS = 2048

# Tier span budgets (tiles) and slot fractions: tier 1 covers every
# gaussian up to a 4x4-tile footprint; the profile's tiers give N / frac
# compacted slots for footprints up to 8x8 and 16x16 tiles.
K1W, K1H = 4, 4
FRAGMENT_PROFILES = {
    # name: ((span_w, span_h, fraction of N), ...) for the compacted tiers
    "lean": ((8, 8, 8), (16, 16, 128)),    # capacity = 16N + 8N + 2N = 26N
    "wide": ((8, 8, 2), (16, 16, 16)),     # capacity = 16N + 32N + 16N = 64N
}
TIERS = FRAGMENT_PROFILES["lean"]


class TileBinning(NamedTuple):
    padded_gid: torch.Tensor     # [P_round] i32 sorted gaussian id (>= N: dummy)
    tile_starts: torch.Tensor    # [T] i32 unaligned offset of each tile's range
    tile_counts: torch.Tensor    # [T] i32 fragments per tile
    num_fragments: torch.Tensor  # [] i32 true (clamped) fragment count
    overflow: torch.Tensor       # [] bool: some gaussian exceeded the top tier


def tile_grid(image_width: int, image_height: int) -> tuple[int, int]:
    return -(-image_width // TILE), -(-image_height // TILE)


def _clip_i32(x: torch.Tensor, hi: int) -> torch.Tensor:
    return torch.clamp(x, 0, hi).to(torch.int32)


def tile_rect(mean2d, radius, tiles_x: int, tiles_y: int):
    """Tile rect per gaussian with the C-truncation semantics of the CUDA
    getRect (the int cast truncates toward zero, then clamps; exclusive
    max). mean2d [2, N]."""
    r = radius.to(torch.float32)
    px, py = mean2d[0], mean2d[1]
    xmin = _clip_i32(torch.trunc((px - r) / TILE), tiles_x)
    ymin = _clip_i32(torch.trunc((py - r) / TILE), tiles_y)
    xmax = _clip_i32(torch.trunc((px + r + TILE - 1) / TILE), tiles_x)
    ymax = _clip_i32(torch.trunc((py + r + TILE - 1) / TILE), tiles_y)
    return xmin, ymin, xmax, ymax


def _expand_tier(xmin, ymin, span_w, span_h, depth, gid, valid,
                 kw: int, kh: int, tiles_x: int, num_tiles: int,
                 n_dummy: int):
    """Broadcast an [M]-gaussian set against a [kw*kh] tile iota, k-major:
    flat (tile id, depth, gaussian id) of length kw*kh*M, with tile id
    num_tiles, depth inf and id n_dummy where the fragment does not exist."""
    k = torch.arange(kw * kh, dtype=torch.int32, device=xmin.device)
    kx = (k % kw)[:, None]
    ky = (k // kw)[:, None]
    ok = valid[None, :] & (kx < span_w[None, :]) & (ky < span_h[None, :])
    tid = (ymin[None, :] + ky) * tiles_x + (xmin[None, :] + kx)
    tid = torch.where(ok, tid, num_tiles)
    d = torch.where(ok, depth[None, :], torch.inf)
    g = torch.where(ok, gid[None, :], n_dummy)
    return tid.reshape(-1), d.reshape(-1), g.reshape(-1).to(torch.int32)


@torch.no_grad()
def bin_splats(
    mean2d: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    tiles_x: int,
    tiles_y: int,
    max_fragments: int | None = None,
    profile: str = "lean",
) -> TileBinning:
    """The padded, depth-sorted per-tile fragment index structure.
    mean2d is [2, N]. The capacity follows N and the profile ("lean" or
    "wide"; any other value raises); `max_fragments` is accepted and not
    used, as in the JAX package."""
    del max_fragments
    if not isinstance(profile, str) or profile not in FRAGMENT_PROFILES:
        raise KeyError(f"legacy binning profile {profile!r}: expected one of "
                       f"{sorted(FRAGMENT_PROFILES)}")
    tiers = FRAGMENT_PROFILES[profile]
    dev = mean2d.device
    n = mean2d.shape[1]
    num_tiles = tiles_x * tiles_y

    xmin, ymin, xmax, ymax = tile_rect(mean2d, radius, tiles_x, tiles_y)
    span_w = xmax - xmin
    span_h = ymax - ymin
    nonempty = visible & (span_w > 0) & (span_h > 0)
    gids = torch.arange(n, dtype=torch.int32, device=dev)

    # tier 1: every gaussian with spans <= K1
    small = nonempty & (span_w <= K1W) & (span_h <= K1H)
    parts = [_expand_tier(
        xmin, ymin, torch.clamp(span_w, max=K1W), torch.clamp(span_h, max=K1H),
        depth, gids, small, K1W, K1H, tiles_x, num_tiles, n)]

    # higher tiers: compacted slots for progressively larger spans
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    prev_w, prev_h = K1W, K1H
    for kw, kh, frac in tiers:
        n_slots = -(-n // frac)
        in_tier = nonempty & ((span_w > prev_w) | (span_h > prev_h))
        last = (kw, kh) == tiers[-1][:2]
        if not last:
            in_tier = in_tier & (span_w <= kw) & (span_h <= kh)
        rank = torch.where(in_tier, torch.cumsum(in_tier, 0) - 1, n_slots)
        keep = rank < n_slots
        slot_src = torch.full((n_slots,), n, dtype=torch.int32, device=dev)
        slot_src[rank[keep]] = gids[keep]
        ok = slot_src < n
        src = torch.clamp(slot_src, 0, n - 1).long()
        parts.append(_expand_tier(
            xmin[src], ymin[src], torch.clamp(span_w[src], max=kw),
            torch.clamp(span_h[src], max=kh), depth[src], src.to(torch.int32),
            ok, kw, kh, tiles_x, num_tiles, n))
        overflow = overflow | (in_tier.sum() > n_slots)
        if last:
            overflow = overflow | torch.any(
                in_tier & ((span_w > kw) | (span_h > kh)))
        prev_w, prev_h = kw, kh

    tile_id = torch.cat([p[0] for p in parts])
    frag_depth = torch.cat([p[1] for p in parts])
    frag_gid = torch.cat([p[2] for p in parts])
    p_total = tile_id.shape[0]

    # stable (tile, depth) sort: by depth, then stably by tile
    by_depth = torch.sort(frag_depth, stable=True).indices
    by_tile = torch.sort(tile_id[by_depth], stable=True).indices
    order = by_depth[by_tile]
    s_tile = tile_id[order].contiguous()
    s_gid = frag_gid[order]

    tile_idx = torch.arange(num_tiles, dtype=s_tile.dtype, device=dev)
    starts = torch.searchsorted(s_tile, tile_idx, side="left").to(torch.int32)
    ends = torch.searchsorted(s_tile, tile_idx, side="right").to(torch.int32)
    tcounts = ends - starts

    # the sorted ids padded to a CHUNK multiple plus one CHUNK; slots without
    # a fragment take the round-robin dummy ids
    p_round = -(-p_total // CHUNK) * CHUNK + CHUNK
    spread = n + torch.arange(p_round, dtype=torch.int32, device=dev) % DUMMY_COLS
    padded_gid = spread.clone()
    padded_gid[:p_total] = torch.where(s_gid >= n, spread[:p_total], s_gid)

    return TileBinning(
        padded_gid=padded_gid,
        tile_starts=starts,
        tile_counts=tcounts,
        num_fragments=tcounts.sum().to(torch.int32),
        overflow=overflow,
    )
