"""Parity of the PyTorch port's renderer with the JAX package on the CPU.

Same numpy-seeded inputs go through the JAX function (its Pallas kernels in
interpret mode, as the JAX suite runs them) and the port (its kernels'
plain PyTorch versions, which are what a CPU tensor gets). Tolerances are
the JAX suite's own: image/alpha 2e-5, depth/normal 2e-4, gradients divided
by their max 5e-4 (tests/test_render.py). Integer index structures must be
equal exactly. The CUDA kernels are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.render import compact as jc
from rodygs_tpu.render import tile_kernel as jtk
from rodygs_tpu.render.binning import tile_grid
from rodygs_tpu.render.preprocess import preprocess as jpreprocess
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu_torch.render import compact as tc
from rodygs_tpu_torch.render import tile_kernel as ttk
from rodygs_tpu_torch.render.camera import Camera as TCamera
from rodygs_tpu_torch.render.preprocess import Splats2D as TSplats2D
from rodygs_tpu_torch.render.rasterize import render as trender

from test_render import H, W, make_scene

IMG_TOL, DEPTH_TOL, GRAD_TOL = 2e-5, 2e-4, 5e-4


def T(x, dtype=None):
    t = torch.tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def tcam_from(cam, requires_grad=False):
    q = T(cam.q_c2w).requires_grad_(requires_grad)
    t = T(cam.t_c2w).requires_grad_(requires_grad)
    return TCamera(q, t, T(cam.fovx), T(cam.fovy), T(cam.time))


def splats_to_torch(s):
    return TSplats2D(*[T(x) for x in s])


def assert_scaled(a, b, tol=GRAD_TOL, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-8
    np.testing.assert_allclose(b / scale, a / scale, atol=tol, err_msg=name)


# --------------------------------------------------------------------------
# capacity helpers and index structure
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fn,args", [
    ("fragment_capacity", [(n, p) for n in (300, 131072, 240000)
                           for p in ("lean", "wide", "huge", 1000, 777777,
                                     ("wide", 2))]),
    ("fit_capacity", [(n, d, b) for n in (300, 131072) for d in (0, 999, 5e5)
                      for b in (1, 2)]),
    ("profile_for_demand", [(n, int(d), cur, b) for n in (300, 131072)
                            for d in (100, 8e5, 4e6, 2e7)
                            for cur in ("lean", "wide", 3_000_000)
                            for b in (1, 3)]),
    ("bands_decision", [(n, c, d) for n in (1000, 240000)
                        for c in (1_000_000, 5_760_000)
                        for d in (100_000, 4_720_000)]),
    ("escalation_poll_due", [(i,) for i in range(0, 260, 5)]),
    ("next_profile", [("lean",), ("wide",), ("huge",)]),
    ("split_profile", [("lean",), (1234,), (("huge", 3),), (["wide", 2],)]),
    ("join_profile", [("lean", 1), ("lean", 3), (5000, 2)]),
    ("depth_key_bits", [(4, 3), (32, 32), (120, 68)]),
    ("padded_width", [(1,), (300,), (131072,)]),
])
def test_capacity_helpers_match(fn, args):
    for a in args:
        assert getattr(tc, fn)(*a) == getattr(jc, fn)(*a), (fn, a)


@pytest.fixture(scope="module")
def scene_splats():
    means, scales, quats, opac, shs, cam = make_scene(n=300, sh_extra=True)
    splats = jpreprocess(means, scales, quats, opac, shs, 3, cam, W, H)
    return splats


@pytest.mark.parametrize("tight", [False, True, "rows"])
def test_build_binning_exact(scene_splats, tight):
    tx, ty = tile_grid(W, H)
    cap = jc.fragment_capacity(300, "lean")
    jb = jc.build_binning(scene_splats, tx, ty, cap, tight=tight)
    tb = tc.build_binning(splats_to_torch(scene_splats), tx, ty, cap,
                          tight=tight)
    for name in jb._fields:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_build_binning_overflow_drops_whole_gaussians(scene_splats):
    tx, ty = tile_grid(W, H)
    cap = 512   # far below the demand: the clamp must drop whole gaussians
    jb = jc.build_binning(scene_splats, tx, ty, cap, tight=True)
    tb = tc.build_binning(splats_to_torch(scene_splats), tx, ty, cap,
                          tight=True)
    assert bool(jb.overflow) and bool(tb.overflow)
    assert int(jb.dropped) > 0
    for name in jb._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


# --------------------------------------------------------------------------
# each kernel's plain version against its Pallas twin
# --------------------------------------------------------------------------


def _jax_stages(splats, tight):
    """One render's kernel inputs/outputs through the JAX package."""
    tx, ty = tile_grid(W, H)
    n = splats.mean2d.shape[1]
    cb = jc.build_binning(splats, tx, ty, jc.fragment_capacity(n, "lean"),
                          tight=tight)
    nw = jc.padded_width(n)
    rec13 = jnp.pad(jnp.concatenate(
        [splats.mean2d, splats.conic, splats.opacity[None], splats.rgb,
         splats.depth[None], splats.normal], axis=0), ((0, 0), (0, nw - n)))
    table = jc.build_table(rec13, cb.aux_rows)
    db = jc.depth_key_bits(tx, ty)
    key, rec = jc.expand_fragments(table, cb.bases, cb.f_kept, tx, db)
    _, rows = jc._sort_fragments(key, rec)
    records = jc._stack_records(rows)
    off = jnp.zeros((1,), jnp.int32)
    out = jtk.rasterize_fwd_impl(records, cb.tile_starts, cb.tile_counts,
                                 off, tx)
    gout = np.random.default_rng(5).normal(size=out.shape).astype(np.float32)
    d_rec = jtk.rasterize_bwd_impl(records, cb.tile_starts, cb.tile_counts,
                                   off, out, jnp.asarray(gout), tx)
    return dict(tx=tx, ty=ty, db=db, cb=cb, table=table, key=key, rec=rec,
                records=records, out=out, gout=gout, d_rec=d_rec, off=off,
                tight=tight)


@pytest.fixture(scope="module", params=[True, "rows"])
def stages(request, scene_splats):
    return _jax_stages(scene_splats, request.param)


@pytest.mark.parametrize("n_rows", [tc.NUM_REC_ROWS, tc.N_CORE_ROWS])
def test_expand_plain_matches_pallas(stages, n_rows):
    """Both table heights (the `stages` fixture: rect and rows mode) and
    both emitted row counts; the JAX kernel always emits 13 rows."""
    s = stages
    assert s["table"].shape[0] == (40 if s["tight"] == "rows" else 24)
    key, rec = tc.expand_fragments(T(s["table"]), T(s["cb"].bases),
                                   T(s["cb"].f_kept), s["tx"], s["db"], n_rows)
    jkey = np.asarray(s["key"])
    np.testing.assert_array_equal(key.numpy(), jkey)
    valid = jkey != np.iinfo(np.int32).max
    assert valid.sum() > 0 and rec.shape == (n_rows, jkey.shape[0])
    # records of invalid slots are junk on the TPU too: compare valid ones
    np.testing.assert_array_equal(rec.numpy()[:, valid],
                                  np.asarray(s["rec"])[:n_rows, valid])


def _tile_inputs(s, include_normal):
    """Torch tile-kernel arguments of the stages; without normals the
    records' normal rows are zeroed, which is what the flag promises."""
    records = np.array(s["records"])
    if not include_normal:
        records[10:13] = 0.0
    return records, (T(records), T(s["cb"].tile_starts),
                     T(s["cb"].tile_counts), T(s["off"]))


@pytest.mark.parametrize("include_normal", [True, False])
def test_tile_fwd_plain_matches_pallas(stages, include_normal):
    s = stages
    records, args = _tile_inputs(s, include_normal)
    out = ttk.rasterize_fwd_impl(*args, s["tx"], include_normal)
    ref = np.asarray(s["out"]) if include_normal else np.asarray(
        jtk.rasterize_fwd_impl(jnp.asarray(records), s["cb"].tile_starts,
                               s["cb"].tile_counts, s["off"], s["tx"]))
    for ch, tol in [(slice(0, 3), IMG_TOL), (slice(3, 7), DEPTH_TOL),
                    (slice(7, 8), IMG_TOL)]:
        np.testing.assert_allclose(out.numpy()[:, ch], ref[:, ch], atol=tol)
    if not include_normal:
        # the 5-channel walk is the 8-channel walk on zero normal rows
        assert torch.equal(out, ttk.rasterize_fwd_impl(*args, s["tx"], True))
        assert not out[:, 4:7].any()


@pytest.mark.parametrize("include_normal", [True, False])
def test_tile_bwd_plain_matches_pallas(stages, include_normal):
    s = stages
    records, args = _tile_inputs(s, include_normal)
    out = ttk.rasterize_fwd_impl(*args, s["tx"], include_normal)
    d_rec = ttk.rasterize_bwd_impl(*args, out, T(s["gout"]), s["tx"],
                                   include_normal)
    ref = np.asarray(s["d_rec"]) if include_normal else np.asarray(
        jtk.rasterize_bwd_impl(jnp.asarray(records), s["cb"].tile_starts,
                               s["cb"].tile_counts, s["off"],
                               jnp.asarray(out.numpy()),
                               jnp.asarray(s["gout"]), s["tx"]))
    # without normals the gradient of the (zero) normal rows is not formed:
    # the caller drops those rows
    for r in range(14):
        if include_normal or r not in (10, 11, 12):
            assert_scaled(ref[r], d_rec.numpy()[r], name=f"row {r}")
    assert not d_rec.numpy()[14:].any()
    if not include_normal:
        full = ttk.rasterize_bwd_impl(*args, out, T(s["gout"]), s["tx"], True)
        live = [r for r in range(16) if r not in (10, 11, 12)]
        assert torch.equal(d_rec[live], full[live])
        assert not d_rec[10:13].any()


def test_segsum_plain_matches_pallas(stages):
    s = stages
    c = s["key"].shape[0]
    # presort-order gradient rows of this render: zero outside fragments
    perm = np.argsort(np.asarray(s["key"]), kind="stable")
    d_presort = np.zeros((13, c), np.float32)
    d_presort[:, perm] = np.asarray(s["d_rec"])[:13]
    ref = np.asarray(jc.segment_sum_rows(jnp.asarray(d_presort), s["table"],
                                         s["cb"].bases))
    got = tc.segment_sum_rows(T(d_presort), T(s["table"]), T(s["cb"].bases),
                              T(s["cb"].f_kept)).numpy()
    assert got.shape == ref.shape
    for r in range(13):
        assert_scaled(ref[r], got[r], tol=1e-5, name=f"row {r}")


# --------------------------------------------------------------------------
# render(): outputs and gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sh_degree,sh_extra,include_normal,bg", [
    (0, False, True, None),
    (3, True, True, None),
    (3, True, False, (0.2, 0.4, 0.6)),
])
def test_render_outputs_match(sh_degree, sh_extra, include_normal, bg):
    means, scales, quats, opac, shs, cam = make_scene(sh_extra=sh_extra)
    jbg = None if bg is None else jnp.asarray(bg, jnp.float32)
    jo = jrender(means, shs, opac, scales, quats, cam, sh_degree, W, H,
                 bg=jbg, include_normal=include_normal)
    to = trender(T(means), T(shs), T(opac), T(scales), T(quats),
                 tcam_from(cam), sh_degree, W, H,
                 bg=None if bg is None else torch.tensor(bg),
                 include_normal=include_normal)
    for k, tol in [("rendered_image", IMG_TOL), ("rendered_alpha", IMG_TOL),
                   ("rendered_depth", DEPTH_TOL),
                   ("rendered_normal", DEPTH_TOL)]:
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   atol=tol, err_msg=k)
    for k in ("radii", "visibility_filter", "num_fragments", "overflow",
              "dropped"):
        np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]),
                                      err_msg=k)


def test_render_overflow_reports_match():
    means, scales, quats, opac, shs, cam = make_scene(n=300)
    kw = dict(fragment_profile=512)   # demand ~700 fragments
    jo = jrender(means, shs, opac, scales, quats, cam, 0, W, H, **kw)
    to = trender(T(means), T(shs), T(opac), T(scales), T(quats),
                 tcam_from(cam), 0, W, H, **kw)
    assert bool(jo["overflow"]) and bool(to["overflow"])
    for k in ("num_fragments", "dropped"):
        assert int(to[k]) == int(jo[k]), k
    np.testing.assert_allclose(to["rendered_image"].numpy(),
                               np.asarray(jo["rendered_image"]), atol=IMG_TOL)


def test_render_grads_match():
    n = 120
    means, scales, quats, opac, shs, cam = make_scene(n=n, sh_extra=True)
    target = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    off0 = np.zeros((2, n), np.float32)

    def jloss(means, scales, quats, opac, shs, cam, off):
        out = jrender(means, shs, opac, scales, quats, cam, 2, W, H,
                      means2d_offset=off)
        return (jnp.mean((out["rendered_image"] - target) ** 2)
                + 0.1 * jnp.mean(out["rendered_depth"])
                + 0.05 * jnp.mean(out["rendered_alpha"]))

    gj = jax.grad(jloss, argnums=tuple(range(7)))(
        means, scales, quats, opac, shs, cam, jnp.asarray(off0))
    leaves = [T(x).requires_grad_(True) for x in (means, scales, quats, opac,
                                                  shs, off0)]
    tcam = tcam_from(cam, requires_grad=True)
    out = trender(leaves[0], leaves[4], leaves[3], leaves[1], leaves[2], tcam,
                  2, W, H, means2d_offset=leaves[5])
    loss = (torch.mean((out["rendered_image"] - torch.tensor(target)) ** 2)
            + 0.1 * torch.mean(out["rendered_depth"])
            + 0.05 * torch.mean(out["rendered_alpha"]))
    loss.backward()
    names = ["means", "scales", "quats", "opac", "shs"]
    for name, a, b in zip(names, gj[:5], leaves[:5]):
        assert_scaled(a, b.grad.numpy(), name=name)
    assert_scaled(gj[5].q_c2w, tcam.q_c2w.grad.numpy(), name="q_c2w")
    assert_scaled(gj[5].t_c2w, tcam.t_c2w.grad.numpy(), name="t_c2w")
    # the JAX package's offset gradient is dL/dpixel / (0.5*[W, H]); the
    # port's is the reference's dL/dpixel * 0.5*[W, H]
    ndc2 = np.array([[(0.5 * W) ** 2], [(0.5 * H) ** 2]], np.float32)
    assert_scaled(np.asarray(gj[6]) * ndc2, leaves[5].grad.numpy(),
                  name="means2d_offset")
    assert np.abs(tcam.q_c2w.grad.numpy()).max() > 0
