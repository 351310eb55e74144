"""The least work of the tile compositors on one render, and the bound it
sets: the larger of bytes over the peak bandwidth and FP32 operations over
the peak rate (one NVIDIA H100 SXM, NVIDIA's data sheet: 3.35 TB/s of HBM3,
67 TFLOP/s in FP32 outside the tensor cores; TF32 is off, so the FP32 rate
is the peak).

The operation counts per (pixel, fragment) pair are those the port's
`chip_smoke.py` arrived at for its kernels, frozen here; an FMA counts as
two and a transcendental as one:

* every evaluated pair: offsets 2, conic form 9, negate and exp 2, opacity
  product 1, clamp 1, two tests 2 => 17; that is all a rejected pair
  costs (sigma < 0, alpha < 1/255, or the pair that stops the pixel);
* a contributing pair adds, forward: log1p, add, stop test, the
  transmittance, the weight, and the accumulate of five live channels
  (r, g, b, depth, alpha; the trainers' renders carry no normal) => 31;
  backward: the same 5, f.g 9, prefix 2, suffix 1, d_alpha 4, clamp select
  1, d_sigma 2, the six geometry gradients 19, five feature gradients and
  the 11-value pixel reduction => 76;
* the rejected pairs cost the smaller of the per-pixel walk (17 each) and,
  for each warp shape, the culled walk: one whole-warp rectangle test (93
  operations: opacity and convexity 8, offsets and the inside test 8, two
  quotients 4, four clamped edge minima of the form 51, the margin's
  magnitude 16, log and compare 6) per (warp, fragment) and 17 for each
  rejected pair inside the (warp, fragment) pairs the test keeps. The warp
  shapes are those of `reference/tiles.py`: "block" 8x4 pixels (what the
  port's kernels use) and "strip" 16x2.

Which pairs count. A fragment is needed in a tile when some pixel of the
tile still evaluates it (has not stopped) and finds alpha >= 1/255 there:
an exact binning lists no other, and the port's conservative one lists a
superset. Pairs are counted over needed fragments only, so the count is a
least-work bound whatever rects the binning draws. Bytes: each needed
fragment's ten record rows read once, the tile ranges, the five live
output planes written (forward); the backward reads the records, the five
live planes of the output and of its cotangent, and writes ten gradient
rows per needed fragment.
"""

from __future__ import annotations

import torch

from ..reference import tiles as TK
from ..reference.render import Binning, block_records, tile_blocks

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
REJECTED_OPS_PER_PAIR = 17
CULL_OPS_PER_TEST = 93
FWD_OPS_PER_CONTRIB = 31
BWD_OPS_PER_CONTRIB = 76
RECORD_ROWS = 10
LIVE_PLANES = 5


def bound_s(bytes_moved: float, ops: float) -> float:
    """The least time of the work on the chip, in seconds."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_FLOPS)


def rejected_ops(contrib: int, rejected: int, warp_pairs: dict) -> int:
    """The smaller of the per-pixel walk and each culled walk."""
    walks = [REJECTED_OPS_PER_PAIR * rejected]
    for n in warp_pairs.values():
        walks.append(CULL_OPS_PER_TEST * n["block_walk"]
                     + REJECTED_OPS_PER_PAIR * (n["kept_lanes"] - contrib))
    return min(walks)


@torch.no_grad()
def walk(rows: torch.Tensor, b: Binning) -> dict:
    """Walk one render's tiles as the compositor does and count: `contrib`
    (pairs that add to a pixel), `rejected` (pairs of needed fragments a
    live pixel evaluates and does not take), `needed` (needed fragments),
    and per warp shape `block_walk` (eight warps per needed fragment) and
    `kept_lanes` (pairs a live pixel evaluates inside the (warp, fragment)
    pairs the whole-warp cull keeps). `rows` [10, N]: mean2d, conic,
    opacity, rgb, depth of every gaussian."""
    out = {"contrib": 0, "rejected": 0, "needed": 0,
           "tiles": int(b.tile_counts.shape[0]),
           "warp_pairs": {s: {"block_walk": 0, "kept_lanes": 0}
                          for s in TK.WARP_SHAPES}}
    for t0, t1, f0, f1 in tile_blocks(b):
        rec, starts, counts, offset = block_records(rows, b, t0, t1, f0, f1)
        px, py = TK._pixel_coords(offset, t1 - t0, b.tiles_x)
        log_t = torch.zeros((t1 - t0, TK.PIX), device=rows.device)
        for _, valid, rc in TK._chunks(rec, starts, counts):
            alpha = TK._chunk_alpha(rc, px, py, valid)[4]
            alive0 = log_t >= TK.LOG_T_EPS
            took, _, _, log_t = TK._walk(alpha, log_t)
            alive = torch.cat([alive0[:, :, None], took[:, :, :-1]], dim=2)
            alive = alive & valid[:, None, :]
            contrib = took & (alpha > 0) & alive
            needed = (alive & (alpha > 0)).any(dim=1)          # [T, K]
            live = alive & needed[:, None, :]
            out["contrib"] += int(contrib.sum())
            out["rejected"] += int((live & ~contrib).sum())
            out["needed"] += int(needed.sum())
            for shape, n in out["warp_pairs"].items():
                keep = TK.warp_cull_keep_plain(rc, offset, b.tiles_x, shape)
                warp_of = TK.warp_of_pixel(shape).to(rows.device)
                n["block_walk"] += TK.NUM_WARPS * int(needed.sum())
                n["kept_lanes"] += int((live & keep[:, warp_of, :]).sum())
    return out


def tile_work(w: dict) -> dict:
    """{"tile_fwd": (bytes, ops), "tile_bwd": (bytes, ops)} of one render's
    `walk` counts."""
    rec = RECORD_ROWS * 4 * w["needed"] + 8 * w["tiles"]
    planes = LIVE_PLANES * w["tiles"] * TK.PIX * 4
    rej = rejected_ops(w["contrib"], w["rejected"], w["warp_pairs"])
    return {"tile_fwd": (rec + planes, FWD_OPS_PER_CONTRIB * w["contrib"]
                         + rej),
            "tile_bwd": (rec + 2 * planes + RECORD_ROWS * 4 * w["needed"],
                         BWD_OPS_PER_CONTRIB * w["contrib"] + rej)}
