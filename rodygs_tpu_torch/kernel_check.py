"""Hold each CUDA kernel against its plain PyTorch version on one render.

`capture_stages` runs one render's forward and backward stage by stage
(preprocess, binning, expand, sort, tile forward, tile backward with a
seeded random cotangent, unsort), keeping every kernel's inputs and
outputs; `check_stages` recomputes each kernel's output with its plain
version on the same inputs and raises `KernelMismatch` past the stated
tolerance. `needed_pairs` counts the (pixel, fragment) pairs the compositor
must evaluate on that data, for the kernels' operation bound.
`random_scene` builds the seeded test scene these checks run on.

Used by `chip_smoke.py` and the on-card tests (tests/test_torch_cuda.py).
On CPU tensors the "kernel" side is itself the plain version, which keeps
this module testable without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import gaussians as G
from .render import compact as C
from .render import tile_kernel as TK
from .ops.sh import rgb2sh
from .render.binning import tile_grid
from .render.camera import make_camera
from .render.preprocess import preprocess

# Tolerances. expand copies records and computes integer keys: exact. Tile
# forward: the JAX suite's image bars (2e-5 rgb/alpha, 2e-4 depth/normal);
# the plain version takes the kernel's arithmetic in its order, so the
# stop decisions agree. Tile backward and segsum divided by their max: the
# 256-pixel sums run as warp trees in the kernel and as torch reductions in
# the plain version (5e-4, the JAX suite's gradient bar); segsum sums in
# fp32 in order against a float64 running sum (1e-5).
TOL_FWD_IMAGE = 2e-5
TOL_FWD_GEOMETRY = 2e-4
TOL_BWD_SCALED = 5e-4
TOL_SEGSUM_SCALED = 1e-5


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


@torch.no_grad()
def capture_stages(params: G.GaussianParams, alive, camera, sh_degree: int,
                   width: int, height: int, profile, tight, seed: int) -> dict:
    """One render's kernel inputs and outputs (normal rows left out of the
    sort, as the trainer renders); the cotangent is seeded normal noise."""
    tx, ty = tile_grid(width, height)
    splats = preprocess(params.xyz, G.get_scaling(params), params.rotation,
                        G.get_opacity(params), G.get_features(params),
                        sh_degree, camera, width, height, alive=alive)
    n = splats.mean2d.shape[1]
    cb = C.build_binning(splats, tx, ty, C.fragment_capacity(n, profile),
                         tight=tight)
    rec13 = torch.nn.functional.pad(torch.cat(
        [splats.mean2d, splats.conic, splats.opacity[None], splats.rgb,
         splats.depth[None], splats.normal], 0), (0, C.padded_width(n) - n))
    table = C.build_table(rec13, cb.aux_rows).contiguous()
    db = C.depth_key_bits(tx, ty)
    key, rec = C.expand_fragments(table, cb.bases, cb.f_kept, tx, db)
    perm, rows = C.sort_fragments(key, rec[:C.N_CORE_ROWS])
    records = C.stack_records(rows)
    off = torch.zeros((1,), dtype=torch.int32, device=table.device)
    out = TK.rasterize_fwd_impl(records, cb.tile_starts, cb.tile_counts,
                                off, tx)
    gen = torch.Generator(device=table.device).manual_seed(seed)
    gout = torch.randn(out.shape, generator=gen, device=table.device)
    d_rec = TK.rasterize_bwd_impl(records, cb.tile_starts, cb.tile_counts,
                                  off, out, gout, tx)
    d_presort = torch.empty((C.N_CORE_ROWS, perm.shape[0]),
                            device=table.device)
    d_presort[:, perm] = d_rec[:C.N_CORE_ROWS]
    return dict(tx=tx, db=db, cb=cb, table=table, key=key, rec=rec,
                records=records, off=off, out=out, gout=gout,
                d_presort=d_presort)


@torch.no_grad()
def check_stages(s: dict) -> dict:
    """Every kernel's output against its plain version on the captured
    inputs. Returns {kernel: max_abs_err}; raises KernelMismatch."""
    cb = s["cb"]
    errs = {}
    pkey, prec = C.expand_fragments_plain(s["table"], cb.bases, cb.f_kept,
                                          s["tx"], s["db"])
    _require(torch.equal(s["key"], pkey), "expand: keys differ")
    valid = pkey != C.INT32_MAX
    _require(int(valid.sum()) > 0, "expand: no valid fragment")
    errs["expand"] = float((s["rec"][:, valid] - prec[:, valid]).abs().max())
    _require(errs["expand"] == 0.0, f"expand: records differ {errs['expand']}")

    args = (s["records"], cb.tile_starts, cb.tile_counts, s["off"])
    diff = (s["out"] - TK.rasterize_fwd_plain(*args, s["tx"])).abs()
    e_img = float(torch.maximum(diff[:, 0:3].max(), diff[:, 7].max()))
    e_geo = float(diff[:, 3:7].max())
    errs["tile_fwd"] = float(diff.max())
    _require(e_img <= TOL_FWD_IMAGE and e_geo <= TOL_FWD_GEOMETRY,
             f"tile_fwd: rgb/alpha {e_img:.3g}, depth/normal {e_geo:.3g}")

    k_rec = TK.rasterize_bwd_impl(*args, s["out"], s["gout"], s["tx"])
    p_rec = TK.rasterize_bwd_plain(*args, s["out"], s["gout"], s["tx"])
    errs["tile_bwd"] = float((k_rec - p_rec).abs().max())
    rel = errs["tile_bwd"] / (float(p_rec.abs().max()) + 1e-30)
    _require(rel <= TOL_BWD_SCALED, f"tile_bwd: scaled error {rel:.3g}")

    seg = C.segment_sum_rows(s["d_presort"], s["table"], cb.f_kept)
    pseg = C.segment_sum_rows_plain(s["d_presort"], s["table"], cb.f_kept)
    errs["segsum"] = float((seg - pseg).abs().max())
    rel = errs["segsum"] / (float(pseg.abs().max()) + 1e-30)
    _require(rel <= TOL_SEGSUM_SCALED, f"segsum: scaled error {rel:.3g}")
    return errs


@torch.no_grad()
def needed_pairs(s: dict) -> tuple[int, int]:
    """(contributing, skipped): the (pixel, fragment) pairs the compositor
    must evaluate on this data — each pixel's fragments up to and including
    the one that stops it — split into those that add to the pixel and
    those it rejects (sigma < 0, alpha < 1/255, or the stopping one)."""
    cb = s["cb"]
    num_tiles = cb.tile_starts.shape[0]
    px, py = TK._pixel_coords(s["off"], num_tiles, s["tx"])
    log_t = torch.zeros((num_tiles, TK.PIX), device=px.device)
    evaluated = contributing = 0
    for _, valid, rec in TK._chunks(s["records"], cb.tile_starts,
                                    cb.tile_counts):
        alpha = TK._chunk_alpha(rec, px, py, valid)[4]
        alive0 = log_t >= TK.LOG_T_EPS
        contrib, _, _, log_t = TK._walk(alpha, log_t)
        # a pixel evaluates fragment k while every earlier one contributed
        alive = torch.cat([alive0[:, :, None], contrib[:, :, :-1]], dim=2)
        evaluated += int((alive & valid[:, None, :]).sum())
        contributing += int((contrib & (alpha > 0)).sum())
    return contributing, evaluated - contributing
