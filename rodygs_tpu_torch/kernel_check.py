"""Hold each CUDA kernel against its plain PyTorch version on one render.

`capture_stages` runs one render's forward and backward stage by stage
(preprocess, binning, expand, sort, tile forward, tile backward with a
seeded random cotangent, unsort), keeping every kernel's inputs and
outputs; `check_stages` recomputes each kernel's output with its plain
version on the same inputs and raises `KernelMismatch` past the stated
tolerance. `check_tiles` does so for the two tile kernels on any ranges,
`synthetic_tiles` makes ranges of chosen lengths. `check_fragment_kernels`
holds expand and segsum alone against theirs (segsum twice for equal
bits), `check_bands` holds all four on a banded binning,
`synthetic_ranges` makes their inputs from chosen slot counts per
gaussian, `slot_stats` describes the slot ranges both walk, and
`poisoned_expand` fills every record the expand contract leaves unwritten
with NaN. `check_tile_splits` composites a captured render in n tile
blocks at their offsets, as the ranks of a tile axis do, against the whole
grid; `check_tile_block` holds the four kernels against their plain
versions on what one such rank runs. `needed_pairs` counts the
(pixel, fragment) pairs the compositor must evaluate on that data, for the
kernels' operation bound; `walk_stats` counts the same walk at warp
granularity. `random_scene` builds the seeded test scene these checks run
on. `check_preprocess` holds the projection stage's forward and backward
(csrc/preprocess.cu) against the plain version on `preprocess_scene`.

Used by `chip_smoke.py` and the on-card tests (tests/test_torch_cuda.py).
On CPU tensors the "kernel" side is itself the plain version, which keeps
this module testable without a card.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .models import gaussians as G
from .render import compact as C
from .render import tile_kernel as TK
from .ops.sh import rgb2sh
from .render.binning import tile_grid
from .render.camera import make_camera
from .render import preprocess as PP
from .render.preprocess import preprocess

# Tolerances. expand copies records and computes integer keys: exact. Tile
# forward: the JAX suite's image bars (2e-5 rgb/alpha, 2e-4 depth/normal);
# the plain version takes the kernel's arithmetic in its order, so the
# stop decisions agree. Tile backward and segsum divided by their max: the
# 256-pixel sums run as warp trees in the kernel and as torch reductions in
# the plain version (5e-4, the JAX suite's gradient bar); segsum sums each
# range in fp32 (in slot order, a long range by lane strides and a shuffle
# tree) against a float64 running sum (1e-5).
TOL_FWD_IMAGE = 2e-5
TOL_FWD_GEOMETRY = 2e-4
TOL_BWD_SCALED = 5e-4
TOL_SEGSUM_SCALED = 1e-5
# the table gradients of n tile blocks summed, against the whole grid's:
# each block's sums run over its own fragments only (1e-5 of the maximum)
TOL_SPLIT_SCALED = 1e-5
# preprocess: the forward takes the plain version's rounded operations in
# their order (2e-6 of each output's max allows a last-bit difference of a
# transcendental); the backward's chain rule, contracted to FMAs, against
# the same rule in torch ops (1e-5 of each gradient's max)
TOL_PREPROCESS_FWD = 2e-6
TOL_PREPROCESS_GRAD = 1e-5


class KernelMismatch(AssertionError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelMismatch(msg)


def random_scene(n: int, seed: int, device, opacity=(0.2, 0.95),
                 log_scale=(-3.5, -2.2)):
    """(params, camera): n random gaussians (numpy seed) in the frustum of
    an identity camera with a 0.9 rad field of view."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    shs = rng.normal(0, 0.05, size=(n, 16, 3)).astype(np.float32)
    shs[:, 0] = rgb2sh(rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32))
    op = rng.uniform(*opacity, size=(n, 1)).astype(np.float32)
    arr = dict(
        xyz=rng.uniform([-1.5, -1.5, 2.0], [1.5, 1.5, 6.0], size=(n, 3)),
        features_dc=shs[:, :1], features_rest=shs[:, 1:],
        scaling=rng.uniform(*log_scale, size=(n, 3)),
        rotation=q, opacity=np.log(op / (1 - op)))
    params = G.GaussianParams(**{
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in arr.items()})
    cam = make_camera([1.0, 0, 0, 0], [0.0, 0, 0], 0.9, 0.9, device=device)
    return params, cam


def _splat_rows(params: G.GaussianParams, alive, camera, sh_degree: int,
                width: int, height: int):
    """(tiles_x, tiles_y, splats, rec13 [13, Nw]) of one view."""
    tx, ty = tile_grid(width, height)
    splats = preprocess(params.xyz, G.get_scaling(params), params.rotation,
                        G.get_opacity(params), G.get_features(params),
                        sh_degree, camera, width, height, alive=alive)
    n = splats.mean2d.shape[1]
    rec13 = torch.nn.functional.pad(torch.cat(
        [splats.mean2d, splats.conic, splats.opacity[None], splats.rgb,
         splats.depth[None], splats.normal], 0), (0, C.padded_width(n) - n))
    return tx, ty, splats, rec13


@torch.no_grad()
def capture_stages(params: G.GaussianParams, alive, camera, sh_degree: int,
                   width: int, height: int, profile, tight, seed: int,
                   include_normal: bool = False) -> dict:
    """One render's kernel inputs and outputs; the cotangent is seeded normal
    noise. include_normal=False leaves the normal rows out of the sort and
    tells the tile kernels so, as the trainer renders."""
    tx, ty, splats, rec13 = _splat_rows(params, alive, camera, sh_degree,
                                        width, height)
    n = splats.mean2d.shape[1]
    cb = C.build_binning(splats, tx, ty, C.fragment_capacity(n, profile),
                         tight=tight)
    table = C.build_table(rec13, cb.aux_rows).contiguous()
    db = C.depth_key_bits(tx, ty)
    n_rows = C.NUM_REC_ROWS if include_normal else C.N_CORE_ROWS
    key, rec = C.expand_fragments(table, cb.bases, cb.f_kept, tx, db, n_rows)
    perm, rows = C.sort_fragments(key, rec)
    records = C.stack_records(rows)
    off = torch.zeros((1,), dtype=torch.int32, device=table.device)
    out = TK.rasterize_fwd_impl(records, cb.tile_starts, cb.tile_counts,
                                off, tx, include_normal)
    gen = torch.Generator(device=table.device).manual_seed(seed)
    gout = torch.randn(out.shape, generator=gen, device=table.device)
    d_rec = TK.rasterize_bwd_impl(records, cb.tile_starts, cb.tile_counts,
                                  off, out, gout, tx, include_normal)
    d_presort = torch.empty((n_rows, perm.shape[0]), device=table.device)
    d_presort[:, perm] = d_rec[:n_rows]
    return dict(tx=tx, db=db, cb=cb, table=table, key=key, rec=rec,
                perm=perm, records=records, off=off, out=out, gout=gout,
                d_presort=d_presort, include_normal=include_normal)


@torch.no_grad()
def capture_legacy(params: G.GaussianParams, alive, camera, sh_degree: int,
                   width: int, height: int, profile: str = "lean") -> dict:
    """The legacy path's binning (render/binning.py) and the records it
    gathers for the tile kernels: [16, P] with P a multiple of CHUNK = 128,
    DUMMY_COLS zero columns behind the gaussians' and row 13 the constant
    alpha feature (rasterize._pack_records)."""
    from .render.binning import bin_splats
    from .render.rasterize import _pack_records

    tx, ty, splats, rec13 = _splat_rows(params, alive, camera, sh_degree,
                                        width, height)
    b = bin_splats(splats.mean2d, splats.depth, splats.radius, splats.visible,
                   tx, ty, profile=profile)
    records = _pack_records(splats).index_select(1, b.padded_gid).contiguous()
    off = torch.zeros((1,), dtype=torch.int32, device=records.device)
    return dict(tx=tx, ty=ty, splats=splats, rec13=rec13, binning=b,
                records=records, off=off)


@torch.no_grad()
def legacy_order(s: dict, capacity: int) -> dict:
    """The legacy binning of `capture_legacy` against the compact one over
    circle rects (tight=False, one band, `capacity` slots): the same tile
    counts, and per tile the same gaussians in an order that may differ
    only where two depths agree in their quantized key bits. The legacy
    sort orders by the float32 depth (ties in tier order), the compact sort
    by the key's depth_key_bits (ties in gaussian order). Returns
    {"reordered": i64 ids of the tiles whose order differs, "fragments":
    the fragment count, "tie_pairs": adjacent fragment pairs of one tile
    whose quantized depths are equal}; raises if the counts differ or an
    order differs otherwise."""
    splats, tx, ty, b = s["splats"], s["tx"], s["ty"], s["binning"]
    cb = C.build_binning(splats, tx, ty, capacity, tight=False)
    _require(int(cb.dropped) == 0, "legacy_order: the compact binning drops")
    _require(torch.equal(cb.tile_counts, b.tile_counts),
             "legacy_order: tile counts differ")
    table = C.build_table(s["rec13"], cb.aux_rows).contiguous()
    db = C.depth_key_bits(tx, ty)
    key, _ = C.expand_fragments(table, cb.bases, cb.f_kept, tx, db,
                                C.N_CORE_ROWS)
    perm = torch.sort(key, stable=True).indices
    dev = key.device
    slots = torch.arange(key.shape[0], device=dev, dtype=torch.float32)
    owner = torch.searchsorted(table[C.ROW_OFF].contiguous(), slots,
                               right=True) - 1
    counts = b.tile_counts.to(torch.int64)
    total = int(counts.sum())
    compact_gid = owner[perm[:total]]
    legacy_gid = b.padded_gid[:total].to(torch.int64)
    tile_of = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), counts)
    qd = C.quantize_depth_bits(splats.depth, db)[legacy_gid]
    # the legacy order re-sorted by (tile, quantized depth, gaussian id)
    order = torch.sort(legacy_gid, stable=True).indices
    order = order[torch.sort(qd[order], stable=True).indices]
    order = order[torch.sort(tile_of[order], stable=True).indices]
    _require(torch.equal(legacy_gid[order], compact_gid),
             "legacy_order: the orders differ beyond quantized-depth ties")
    same_tile = tile_of[1:] == tile_of[:-1]
    return {
        "reordered": torch.unique(tile_of[compact_gid != legacy_gid]),
        "fragments": total,
        "order": order,
        "tie_pairs": int((same_tile & (qd[1:] == qd[:-1])).sum()),
    }


@torch.no_grad()
def check_bands(params: G.GaussianParams, alive, camera, sh_degree: int,
                width: int, height: int, profile, tight, bands: int,
                seed: int = 1):
    """All four kernels on one view's banded binning against their plain
    versions: expand and segsum on every band (`check_fragment_kernels`:
    keys equal in every slot of the band, segsum within TOL_SEGSUM_SCALED
    of its maximum and the same bits twice) on seeded normal gradient rows,
    then the two tile kernels (`check_tiles`) on the bands' sorted records
    concatenated as the render lays them out: band b's ranges start at
    b * its capacity, and the slots past its f_kept hold whatever expand
    left there. Returns ({kernel: max_abs_err over the bands}, the
    CompactBinning)."""
    tx, ty, splats, rec13 = _splat_rows(params, alive, camera, sh_degree,
                                        width, height)
    n = splats.mean2d.shape[1]
    cb = C.build_binning(splats, tx, ty, C.fragment_capacity(n, profile),
                         tight=tight, bands=bands)
    _require(cb.f_kept.dim() == 1, "the binning is not banded")
    db = C.depth_key_bits(tx, ty)
    gen = torch.Generator(device=rec13.device).manual_seed(seed)
    errs, rows = {}, []
    for b in range(cb.f_kept.shape[0]):
        table = C.build_table(rec13, cb.aux_rows[b]).contiguous()
        d = torch.randn((C.N_CORE_ROWS, cb.bases.shape[1] * C.FCHUNK),
                        generator=gen, device=rec13.device)
        key, rec = C.expand_fragments(table, cb.bases[b], cb.f_kept[b], tx,
                                      db, C.N_CORE_ROWS)
        for k, v in check_fragment_kernels(table, cb.bases[b], cb.f_kept[b],
                                           tx, db, d, key=key,
                                           rec=rec).items():
            errs[k] = max(errs.get(k, 0.0), v)
        rows.append(C.sort_fragments(key, rec)[1])
    off = torch.zeros((1,), dtype=torch.int32, device=rec13.device)
    errs.update(check_tiles(C.stack_records(torch.cat(rows, dim=1)),
                            cb.tile_starts, cb.tile_counts, off, tx, False,
                            seed=seed))
    return errs, cb


@torch.no_grad()
def check_tiles(records, tile_starts, tile_counts, off, tx: int,
                include_normal: bool, out=None, gout=None, seed: int = 1
                ) -> dict:
    """The two tile kernels against their plain versions on these ranges;
    the backward runs twice and must give the same bits. `out` / `gout`
    default to the kernel's forward and seeded normal noise. Returns
    {"tile_fwd": max_abs_err, "tile_bwd": max_abs_err}."""
    args = (records, tile_starts, tile_counts, off)
    if out is None:
        out = TK.rasterize_fwd_impl(*args, tx, include_normal)
    if gout is None:
        gen = torch.Generator(device=records.device).manual_seed(seed)
        gout = torch.randn(out.shape, generator=gen, device=records.device)
    errs = {}
    diff = (out - TK.rasterize_fwd_plain(*args, tx, include_normal)).abs()
    e_img = float(torch.maximum(diff[:, 0:3].max(), diff[:, 7].max()))
    e_geo = float(diff[:, 3:7].max())
    errs["tile_fwd"] = float(diff.max())
    _require(e_img <= TOL_FWD_IMAGE and e_geo <= TOL_FWD_GEOMETRY,
             f"tile_fwd: rgb/alpha {e_img:.3g}, depth/normal {e_geo:.3g}")

    k_rec = TK.rasterize_bwd_impl(*args, out, gout, tx, include_normal)
    if records.is_cuda:   # on the CPU both runs are the plain version
        again = TK.rasterize_bwd_impl(*args, out, gout, tx, include_normal)
        _require(torch.equal(k_rec, again), "tile_bwd: two runs differ")
    p_rec = TK.rasterize_bwd_plain(*args, out, gout, tx, include_normal)
    errs["tile_bwd"] = float((k_rec - p_rec).abs().max())
    rel = errs["tile_bwd"] / (float(p_rec.abs().max()) + 1e-30)
    _require(rel <= TOL_BWD_SCALED, f"tile_bwd: scaled error {rel:.3g}")
    return errs


@torch.no_grad()
def check_fragment_kernels(table, bases, f_kept, tx: int, db: int,
                           d_presort, key=None, rec=None) -> dict:
    """expand and segsum against their plain versions on these inputs: keys
    equal in every slot, records equal on the slots that carry a fragment
    (the rest is left unwritten), segsum within TOL_SEGSUM_SCALED of the
    plain sums' maximum and, on the card, the same bits from a second run.
    `key` / `rec` default to a fresh run of the expand wrapper. Returns
    {"expand": max_abs_err, "segsum": max_abs_err}."""
    n_rows = d_presort.shape[0]
    if key is None:
        key, rec = C.expand_fragments(table, bases, f_kept, tx, db, n_rows)
    errs = {}
    pkey, prec = C.expand_fragments_plain(table, bases, f_kept, tx, db,
                                          rec.shape[0])
    _require(torch.equal(key, pkey), "expand: keys differ")
    valid = pkey != C.INT32_MAX
    errs["expand"] = 0.0
    if bool(valid.any()):
        errs["expand"] = float((rec[:, valid] - prec[:, valid]).abs().max())
    _require(errs["expand"] == 0.0, f"expand: records differ {errs['expand']}")

    seg = C.segment_sum_rows(d_presort, table, bases, f_kept)
    if d_presort.is_cuda:   # on the CPU both runs are the plain version
        again = C.segment_sum_rows(d_presort, table, bases, f_kept)
        _require(torch.equal(seg, again), "segsum: two runs differ")
    pseg = C.segment_sum_rows_plain(d_presort, table, f_kept)
    _require(bool(torch.isfinite(seg).all()), "segsum: non-finite sums")
    errs["segsum"] = float((seg - pseg).abs().max())
    rel = errs["segsum"] / (float(pseg.abs().max()) + 1e-30)
    _require(rel <= TOL_SEGSUM_SCALED, f"segsum: scaled error {rel:.3g}")
    return errs


@torch.no_grad()
def check_stages(s: dict, tiles: bool = True) -> dict:
    """Every kernel's output against its plain version on the captured
    inputs; tiles=False leaves the two tile kernels out (their plain
    versions walk lane by lane and are slow on a large render). Returns
    {kernel: max_abs_err}; raises KernelMismatch."""
    cb = s["cb"]
    _require(int((s["key"] != C.INT32_MAX).sum()) > 0,
             "expand: no valid fragment")
    errs = check_fragment_kernels(s["table"], cb.bases, cb.f_kept, s["tx"],
                                  s["db"], s["d_presort"], key=s["key"],
                                  rec=s["rec"])
    if tiles:
        errs.update(check_tiles(s["records"], cb.tile_starts, cb.tile_counts,
                                s["off"], s["tx"], s["include_normal"],
                                out=s["out"], gout=s["gout"]))
    return errs


def _block_cotangent(gout, n_blocks: int, index: int):
    """Block `index` of n of the planes' cotangent, the last block padded
    with zero planes (rasterize.tile_block's blocks)."""
    t = gout.shape[0]
    t_local = -(-t // n_blocks)
    pad = torch.nn.functional.pad(gout, (0, 0, 0, 0, 0, n_blocks * t_local - t))
    return pad[index * t_local:(index + 1) * t_local].contiguous()


def check_tile_splits(s: dict, splits) -> dict:
    """The captured render's compositing (`composite_compact`: expand,
    sort, tile forward; tile backward, unsort, segsum) split into n
    contiguous tile blocks, each at its global tile offset, as the ranks of
    a tile axis run it: the blocks' planes concatenated must equal the
    whole grid's bit for bit, and the blocks' table gradients summed must
    lie within TOL_SPLIT_SCALED of the whole grid's maximum. Returns {n:
    scaled error of the summed gradients}."""
    from .render.rasterize import tile_block

    cb, tx = s["cb"], s["tx"]
    num_tiles = cb.tile_starts.shape[0]

    def composite(starts, counts, off, gout):
        table = s["table"].detach().clone().requires_grad_(True)
        out = C.composite_compact(table, cb.bases, cb.f_kept, starts, counts,
                                  off, tx, num_tiles // tx,
                                  s["include_normal"])
        (d_table,) = torch.autograd.grad(out, table, gout)
        return out.detach(), d_table

    whole, d_whole = composite(cb.tile_starts, cb.tile_counts, s["off"],
                               s["gout"])
    scale = float(d_whole.abs().max()) + 1e-30
    errs = {}
    for n in splits:
        outs, d_sum = [], torch.zeros_like(d_whole)
        for i in range(n):
            starts, counts, off = tile_block(cb.tile_starts, cb.tile_counts,
                                             n, i, num_tiles)
            out, d = composite(starts, counts, off,
                               _block_cotangent(s["gout"], n, i))
            outs.append(out)
            d_sum += d
        _require(torch.equal(torch.cat(outs)[:num_tiles], whole),
                 f"{n} tile blocks: the planes differ from the whole grid's")
        errs[n] = float((d_sum - d_whole).abs().max()) / scale
        _require(errs[n] <= TOL_SPLIT_SCALED,
                 f"{n} tile blocks: summed table gradients off by {errs[n]:.3g}"
                 " of their max")
    return errs


@torch.no_grad()
def check_tile_block(s: dict, n_blocks: int, index: int) -> dict:
    """The four kernels against their plain versions on what rank `index`
    of an n-block tile axis runs on the captured render: expand on the
    whole table, the tile kernels on its block at its offset, segsum on the
    block's fragment gradients. The tile backward must leave every fragment
    outside the block at exactly zero. Returns {kernel: max_abs_err}."""
    from .render.rasterize import tile_block

    cb, tx, rec = s["cb"], s["tx"], s["records"]
    starts, counts, off = tile_block(cb.tile_starts, cb.tile_counts, n_blocks,
                                     index, cb.tile_starts.shape[0])
    gout = _block_cotangent(s["gout"], n_blocks, index)
    out = TK.rasterize_fwd_impl(rec, starts, counts, off, tx,
                                s["include_normal"])
    errs = check_tiles(rec, starts, counts, off, tx, s["include_normal"],
                       out=out, gout=gout)
    d_rec = TK.rasterize_bwd_impl(rec, starts, counts, off, out, gout, tx,
                                  s["include_normal"])
    # the block's fragments: the union of its tiles' column ranges
    edge = torch.zeros(rec.shape[1] + 1, dtype=torch.int64, device=rec.device)
    edge.index_add_(0, starts.long(), (counts > 0).long())
    edge.index_add_(0, (starts + counts).long(), -(counts > 0).long())
    inside = torch.cumsum(edge, 0)[:-1] > 0
    _require(bool((d_rec[:, ~inside] == 0).all()),
             "tile_bwd: a gradient outside the rank's block")
    n_rows = s["d_presort"].shape[0]
    d_presort = torch.empty_like(s["d_presort"])
    d_presort[:, s["perm"]] = d_rec[:n_rows]
    errs.update(check_fragment_kernels(s["table"], cb.bases, cb.f_kept, tx,
                                       s["db"], d_presort, key=s["key"],
                                       rec=s["rec"]))
    return errs


@contextlib.contextmanager
def poisoned_expand():
    """While active, `expand_fragments` is handed a record buffer full of
    NaN, so every record the kernel leaves unwritten (slots at or past
    f_kept) is NaN instead of stale memory. A render and its gradients
    must come out with the same bits: nothing reads those records."""
    real = C.expand_fragments

    def poisoned(table, bases, f_kept, tiles_x, db, n_rows=C.NUM_REC_ROWS):
        rec = torch.full((n_rows, bases.shape[0] * C.FCHUNK), float("nan"),
                         device=table.device)
        return real(table, bases, f_kept, tiles_x, db, n_rows, rec_out=rec)

    C.expand_fragments = poisoned
    try:
        yield
    finally:
        C.expand_fragments = real


@torch.no_grad()
def slot_stats(s: dict) -> dict:
    """The slot ranges of one captured render, as expand and segsum walk
    them. `slots_per_gaussian`: mean, p50, p99 and max of the range lengths
    over the gaussians that own a filled slot; `share_over_32` /
    `share_over_512`: the share of the filled slots that lie in ranges
    longer than 32 / 512; `cross_chunk`: ranges that cross an edge between
    two FCHUNK-slot chunks; `owning_columns` of `table_columns`;
    `filled_chunks` of `chunks`."""
    cb = s["cb"]
    cap = cb.bases.shape[0] * C.FCHUNK
    end = min(int(cb.f_kept), cap)
    off = s["table"][C.ROW_OFF].to(torch.int64)
    lo = torch.clamp(off, max=end)
    hi = torch.clamp(torch.cat([off[1:], off.new_tensor([end])]), max=end)
    length = (hi - lo)[hi > lo]
    first, last = lo[hi > lo] // C.FCHUNK, (hi[hi > lo] - 1) // C.FCHUNK
    x = length.to(torch.float64)
    filled = max(end, 1)
    return {
        "f_kept": end, "capacity": cap,
        "slots_per_gaussian": {
            "mean": float(x.mean()), "p50": float(x.quantile(0.5)),
            "p99": float(x.quantile(0.99)), "max": float(x.max())},
        "share_over_32": float(length[length > 32].sum()) / filled,
        "share_over_512": float(length[length > 512].sum()) / filled,
        "cross_chunk": int((first != last).sum()),
        "owning_columns": int(length.numel()),
        "table_columns": int(off.numel()),
        "filled_chunks": -(-end // C.FCHUNK), "chunks": cb.bases.shape[0],
    }


def synthetic_tiles(counts, seed: int, device, tiles_x: int,
                    tile_id_offset: int = 0, opacity=(0.002, 0.6)):
    """(records [16, P], tile_starts, tile_counts, off): hand-made abutting
    tile ranges of the given lengths, for the batch edges of the tile
    kernels. Fragments are random blobs and needles centred in and around
    their tile (numpy seed), opacities on both sides of 1/255, normal rows
    zero and the alpha feature one, with a tail of unused columns."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    p_cols = total + 37
    tile = np.repeat(np.arange(len(counts)) + tile_id_offset, counts)
    cx = (tile % tiles_x) * TK.TILE + 7.5
    cy = (tile // tiles_x) * TK.TILE + 7.5
    rec = np.zeros((TK.NUM_FIELDS, p_cols), np.float32)
    rec[0, :total] = cx + rng.uniform(-14, 14, total)
    rec[1, :total] = cy + rng.uniform(-14, 14, total)
    # conic = R diag(1/s1^2, 1/s2^2) R^T with axes from 0.3 to 20 pixels
    s1, s2 = np.exp(rng.uniform(np.log(0.3), np.log(20.0), (2, total)))
    th = rng.uniform(0, np.pi, total)
    c, s = np.cos(th), np.sin(th)
    rec[2, :total] = c * c / s1**2 + s * s / s2**2
    rec[3, :total] = c * s * (1 / s1**2 - 1 / s2**2)
    rec[4, :total] = s * s / s1**2 + c * c / s2**2
    rec[5, :total] = np.exp(rng.uniform(*np.log(opacity), total))
    rec[6:9, :total] = rng.uniform(0.0, 1.0, (3, total))
    rec[9, :total] = np.sort(rng.uniform(2.0, 7.0, total))
    rec[13] = 1.0
    starts = np.cumsum(counts) - counts
    as_i32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                    device=device)
    return (torch.tensor(rec, device=device), as_i32(starts), as_i32(counts),
            as_i32([tile_id_offset]))


def synthetic_ranges(counts, chunks: int, f_kept: int, seed: int, device,
                     rows_mode: bool = False, n_rows: int = C.N_CORE_ROWS,
                     tiles_x: int = 8, tiles_y: int = 8):
    """Hand-made inputs of expand and segsum: gaussian g owns counts[g] >= 1
    consecutive slots, the capacity is chunks * FCHUNK (gaussians whose
    slots lie past it are the dropped ones), f_kept any slot index up to
    it. Returns (table, bases, f_kept, d_presort, db): the table's offsets
    row and the chunk windows as `build_binning` lays them out, seeded
    whole-number aux rows (spans 0..5 wide, half the columns in row mode
    when `rows_mode`), normal record rows, and normal gradient rows that
    are NaN at and past f_kept, where nothing may read them."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int64)
    assert counts.min() >= 1
    n, cap = len(counts), chunks * C.FCHUNK
    assert 0 <= f_kept <= cap and counts.sum() + n < 2**24
    nw = C.padded_width(n)
    off_next = np.cumsum(counts)
    num_tiles = tiles_x * tiles_y
    db = C.depth_key_bits(tiles_x, tiles_y)
    aux = np.zeros((4 + (1 + 2 * C.ROW_SPAN_MAX) * rows_mode, nw), np.float32)
    aux[0, :n] = rng.integers(0, num_tiles + 1, n)
    aux[1, :n] = rng.integers(0, 2**db, n)
    aux[2, :n] = off_next - counts
    aux[2, n:] = np.arange(nw - n, dtype=np.float32) + C._OFF_PAD
    aux[3, :n] = rng.integers(0, 6, n)
    if rows_mode:
        aux[4, :n] = rng.integers(0, 2, n)
        spans = rng.integers(0, 6, (C.ROW_SPAN_MAX, n))
        aux[5:5 + C.ROW_SPAN_MAX, :n] = np.cumsum(spans, axis=0) - spans
        aux[5 + C.ROW_SPAN_MAX:, :n] = rng.integers(0, tiles_x, spans.shape)
    rec13 = np.zeros((C.NUM_REC_ROWS, nw), np.float32)
    rec13[:, :n] = rng.normal(size=(C.NUM_REC_ROWS, n))
    first_g = np.searchsorted(off_next, np.arange(chunks) * C.FCHUNK,
                              side="right")
    bases = np.clip(first_g // 128 * 128, 0, nw - C.WIN).astype(np.int32)
    d = rng.normal(size=(n_rows, cap)).astype(np.float32)
    d[:, f_kept:] = np.nan
    t = lambda a: torch.tensor(a, device=device)
    return (C.build_table(t(rec13), t(aux)), t(bases),
            torch.tensor(f_kept, dtype=torch.int32, device=device), t(d), db)


def _walked_chunks(s: dict):
    """Walk the captured render chunk by chunk. Yields per chunk
    (rec, valid [T, K], alpha [T, PIX, K] (0 where rejected), alive
    [T, PIX, K]: the pixel evaluates the fragment, i.e. every earlier one it
    took kept it above the stop threshold, contrib [T, PIX, K])."""
    cb = s["cb"]
    num_tiles = cb.tile_starts.shape[0]
    px, py = TK._pixel_coords(s["off"], num_tiles, s["tx"])
    log_t = torch.zeros((num_tiles, TK.PIX), device=px.device)
    for _, valid, rec in TK._chunks(s["records"], cb.tile_starts,
                                    cb.tile_counts):
        alpha = TK._chunk_alpha(rec, px, py, valid)[4]
        alive0 = log_t >= TK.LOG_T_EPS
        contrib, _, _, log_t = TK._walk(alpha, log_t)
        alive = torch.cat([alive0[:, :, None], contrib[:, :, :-1]], dim=2)
        yield (rec, valid, alpha, alive & valid[:, None, :],
               contrib & (alpha > 0))


@torch.no_grad()
def needed_pairs(s: dict) -> tuple[int, int]:
    """(contributing, skipped): the (pixel, fragment) pairs the compositor
    must evaluate on this data — each pixel's fragments up to and including
    the one that stops it — split into those that add to the pixel and
    those it rejects (sigma < 0, alpha < 1/255, or the stopping one)."""
    evaluated = contributing = 0
    for _, _, _, alive, contrib in _walked_chunks(s):
        evaluated += int(alive.sum())
        contributing += int(contrib.sum())
    return contributing, evaluated - contributing


def _any_per_warp(x: torch.Tensor, shape: str) -> torch.Tensor:
    """[T, PIX, K] bool -> [T, 8, K]: true where any pixel of the warp is."""
    w, h = TK.WARP_SHAPES[shape]
    t, _, k = x.shape
    x = x.reshape(t, TK.TILE // h, h, TK.TILE // w, w, k)
    return x.any(dim=4).any(dim=2).reshape(t, TK.NUM_WARPS, k)


@torch.no_grad()
def walk_stats(s: dict) -> dict:
    """What a one-block-per-tile, one-warp-per-rectangle walk of this data
    costs at warp granularity. `tile_counts` / `tile_walked`: mean, p50, p99
    and max of the tiles' range lengths and of the fragments a tile walks
    before all its pixels have stopped (the heaviest is the floor of a
    block's serial walk). For each warp shape of `TK.WARP_SHAPES`, counts of
    (warp, fragment) pairs: `block_walk` all warps walk while any pixel of
    the TILE is alive (no warp-level exit or cull), `evaluates` some lane
    evaluates the pair, `passes` some lane's alpha test passes (it
    contributes or stops there), `contributes` some lane contributes,
    `kept` some lane evaluates and the conservative cull keeps the pair;
    and `kept_lanes`, the (pixel, fragment) pairs a pixel evaluates inside
    the kept pairs: what a culled walk still has to evaluate lane by lane."""
    cb = s["cb"]
    names = ("block_walk", "evaluates", "passes", "contributes", "kept",
             "kept_lanes")
    pairs = {shape: dict.fromkeys(names, 0) for shape in TK.WARP_SHAPES}
    walked = torch.zeros_like(cb.tile_counts, dtype=torch.int64)
    for rec, _, alpha, alive, contrib in _walked_chunks(s):
        tile_alive = alive.any(dim=1)                       # [T, K]
        walked += tile_alive.sum(dim=1)
        for shape, n in pairs.items():
            ev = _any_per_warp(alive, shape)
            keep = TK.warp_cull_keep_plain(rec, s["off"], s["tx"], shape)
            n["block_walk"] += TK.NUM_WARPS * int(tile_alive.sum())
            n["evaluates"] += int(ev.sum())
            n["passes"] += int(_any_per_warp(alive & (alpha > 0), shape).sum())
            n["contributes"] += int(_any_per_warp(contrib, shape).sum())
            n["kept"] += int((ev & keep).sum())
            warp_of = TK.warp_of_pixel(shape).to(keep.device)
            n["kept_lanes"] += int((alive & keep[:, warp_of, :]).sum())

    def dist(x):
        x = x.to(torch.float64)
        return {"mean": float(x.mean()), "p50": float(x.quantile(0.5)),
                "p99": float(x.quantile(0.99)), "max": float(x.max())}

    return {"tile_counts": dist(cb.tile_counts), "tile_walked": dist(walked),
            "warp_pairs": pairs}


def preprocess_scene(n: int, n_alive: int, seed: int, device, sh_coeffs=16):
    """(inputs dict, alive, camera) for the projection stage: n slots, the
    first n_alive alive and the rest all-zero as a store's dead slots;
    points in front of, beside and behind a rotated camera (fov 0.9), log
    scales in [-5, -1], SH coefficients N(0, 0.3) (colours below 0 too)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    ins = dict(
        means3d=rng.uniform([-4.0, -4.0, -0.5], [4.0, 4.0, 7.0], (n, 3)),
        scales=np.exp(rng.uniform(-5.0, -1.0, (n, 3))),
        quats=rng.normal(size=(n, 4)),
        shs=rng.normal(0.0, 0.3, (n, sh_coeffs, 3)),
        opacities=rng.uniform(0.005, 1.0, n))
    for k in ("means3d", "scales", "quats", "shs"):
        ins[k][n_alive:] = 0.0
    ins = {k: f32(v) for k, v in ins.items()}
    alive = torch.arange(n, device=device) < n_alive
    cam = make_camera([0.99, 0.05, -0.1, 0.02], [0.1, -0.2, 0.3], 0.9, 0.9,
                      device=device)
    return ins, alive, cam


def check_preprocess(n: int, n_alive: int, sh_degree: int, device,
                     seed: int = 0, width: int = 512, height: int = 512,
                     cam_grad: bool = True) -> dict:
    """The projection stage's forward and backward (on a CUDA device the
    kernels, on the CPU the plain version again) against the plain version
    on `preprocess_scene`. Raises KernelMismatch unless radius, visibility
    and the compact binning built from the outputs are equal, the float
    outputs lie within TOL_PREPROCESS_FWD of each output's max, every
    gradient within TOL_PREPROCESS_GRAD of its max, and two backward calls
    give the same bits. Returns the readings: fwd_err, fwd_bits (the
    float outputs equal bit for bit), grad_err, grad_bits (the gradients
    of means, scales, quats and shs equal bit for bit), visible (count)."""
    ins, alive, cam = preprocess_scene(n, n_alive, seed, device)
    w2c, full_proj, campos = (x.detach() for x in PP._camera(cam))
    args = (ins["means3d"], ins["scales"], ins["quats"], ins["shs"], None,
            w2c, full_proj, campos, ins["opacities"], alive, cam.fovx,
            cam.fovy, sh_degree, width, height, 1.0)
    got = PP._forward(*args)
    with torch.no_grad():
        want = PP._project_plain(
            ins["means3d"], ins["scales"], ins["quats"], ins["opacities"],
            ins["shs"], sh_degree, w2c, full_proj, campos, cam.fovx,
            cam.fovy, width, height, 1.0, alive, None)
    names = ("mean2d", "conic", "depth", "rgb", "normal", "radius",
             "visible", "ext")
    for name in ("radius", "visible"):
        k = names.index(name)
        _require(torch.equal(got[k], want[k]), f"preprocess {name} differs")
    fwd_err, fwd_bits = 0.0, True
    for name, a, b in zip(names, got, want):
        if name in ("radius", "visible"):
            continue
        fwd_bits &= torch.equal(a, b)
        fwd_err = max(fwd_err, float((a - b).abs().max()
                                     / b.abs().max().clamp(min=1e-30)))
    _require(fwd_err <= TOL_PREPROCESS_FWD,
             f"preprocess forward: {fwd_err:.3g} of the max")
    tx, ty = tile_grid(width, height)
    cap = C.fragment_capacity(n, "lean")
    bins = [C.build_binning(PP._splats(f, ins["opacities"], False), tx, ty,
                            cap, tight=True) for f in (got, want)]
    for field, a, b in zip(bins[0]._fields, *bins):
        _require(torch.equal(a, b), f"preprocess binning: {field} differs")

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cots = tuple(torch.randn(t.shape, generator=gen, device=device)
                 for t in got[:5])
    needs = (True, True, True, True, False) + (cam_grad,) * 3
    saved = (ins["means3d"], ins["scales"], ins["quats"], ins["shs"], w2c,
             full_proj, campos, alive, cam.fovx, cam.fovy, sh_degree, width,
             height, 1.0, False, cots, needs)
    back = (PP.preprocess_cuda_bwd if ins["means3d"].is_cuda
            else PP.preprocess_backward_plain)
    grads = back(*saved)
    again = back(*saved)
    ref = PP.preprocess_backward_plain(*saved)
    grad_err, grad_bits = 0.0, True
    for k, (a, b, c) in enumerate(zip(grads, ref, again)):
        if b is None:
            continue
        _require(torch.equal(a, c), f"preprocess backward: gradient {k} "
                 "differs between two calls")
        if k < 4:    # the per-Gaussian gradients; the camera's are sums
            grad_bits &= torch.equal(a, b)
        grad_err = max(grad_err, float((a - b).abs().max()
                                       / b.abs().max().clamp(min=1e-30)))
    _require(grad_err <= TOL_PREPROCESS_GRAD,
             f"preprocess backward: {grad_err:.3g} of the max")
    return dict(fwd_err=fwd_err, fwd_bits=bool(fwd_bits), grad_err=grad_err,
                grad_bits=bool(grad_bits), visible=int(got[6].sum()))
