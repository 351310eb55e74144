"""The legacy render, the render's tight-rect and band rules, the dense
oracle and the row-sparse camera Adam: the port against the JAX package on
the CPU.

Same numpy-seeded scenes (tests/test_render.py, 64x48) go through both
packages; the JAX side runs its Pallas kernels in interpret mode, as its
own tests do. Tolerances are the JAX suite's: image/alpha 2e-5,
depth/normal 2e-4, gradients divided by their max 5e-4. Integer index
structures, the legacy path against the compact one (circle rects), renders
that the environment or a clamped band count must not change and the
sparse Adam's trajectory must be equal exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.render import binning as jb
from rodygs_tpu.render import compact as jc
from rodygs_tpu.render import rasterize as jr
from rodygs_tpu.render.composite_ref import composite_reference as jref
from rodygs_tpu.render.preprocess import preprocess as jpreprocess
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_joint as jtj
from rodygs_tpu.train import trainer_static as jts
from rodygs_tpu_torch import convert
from rodygs_tpu_torch import kernel_check as KC
from rodygs_tpu_torch.render import binning as tb
from rodygs_tpu_torch.render import compact as tc
from rodygs_tpu_torch.render import rasterize as tr
from rodygs_tpu_torch.render.composite_ref import composite_reference as tref
from rodygs_tpu_torch.render.preprocess import preprocess as tpreprocess
from rodygs_tpu_torch.train import losses as tlosses
from rodygs_tpu_torch.train import optim as toptim
from rodygs_tpu_torch.train import trainer_joint as ttj
from rodygs_tpu_torch.train import trainer_static as tts

from test_render import H, W, make_scene
from test_torch_render import T, assert_scaled, tcam_from
from test_torch_train import _bench_like_setup

IMG_TOL, DEPTH_TOL = 2e-5, 2e-4
OUT_KEYS = ("rendered_image", "rendered_depth", "rendered_alpha",
            "rendered_normal")
REPO = Path(__file__).resolve().parents[1]


def _assert_images(got, want, keys=OUT_KEYS):
    for k in keys:
        tol = DEPTH_TOL if k in ("rendered_depth", "rendered_normal") else IMG_TOL
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def _loss_terms(out, target):
    return ((out["rendered_image"] - target) ** 2).mean() \
        + 0.1 * out["rendered_depth"].mean() \
        + 0.05 * out["rendered_alpha"].mean()


def _jax_render_grads(scene, **kw):
    """(outputs, gradients over means, scales, quats, opac, shs, q, t)."""
    means, scales, quats, opac, shs, cam = scene
    target = jnp.full((H, W, 3), 0.3)

    def loss(means, scales, quats, opac, shs, cam):
        out = jr.render(means, shs, opac, scales, quats, cam, **kw)
        return _loss_terms(out, target), out

    g, out = jax.grad(loss, argnums=(0, 1, 2, 3, 4, 5), has_aux=True)(
        means, scales, quats, opac, shs, cam)
    return out, [np.asarray(x) for x in g[:5]] + [
        np.asarray(g[5].q_c2w), np.asarray(g[5].t_c2w)]


def _port_render_grads(scene, **kw):
    means, scales, quats, opac, shs, cam = scene
    leaves = [T(x).requires_grad_(True)
              for x in (means, scales, quats, opac, shs)]
    m, s, q, o, sh = leaves
    tcam = tcam_from(cam, requires_grad=True)
    out = tr.render(m, sh, o, s, q, tcam, **kw)
    _loss_terms(out, 0.3).backward()
    grads = [x.grad for x in leaves] + [tcam.q_c2w.grad, tcam.t_c2w.grad]
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in out.items()}, grads


RENDER_KW = dict(sh_degree=3, image_width=W, image_height=H)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch on one thread: between the JAX compiles here and the suite's
    other worker processes, torch's OpenMP barriers wait on descheduled
    threads (tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene250():
    return make_scene(n=250, sh_extra=True)


# --------------------------------------------------------------------------
# legacy binning and render
# --------------------------------------------------------------------------


def _blown(scene):
    """The scene with every gaussian large."""
    means, scales, quats, opac, shs, cam = scene
    return means, jnp.full_like(scales, 0.6), quats, opac, shs, cam


# 320x240 (20x15 tiles): spans reach every tier; "lean" overflows its
# 8x8 tier (N/8 slots), "wide" holds the scene; blown, spans pass 16 tiles
@pytest.mark.parametrize("profile,blown,overflow", [
    ("lean", False, True), ("wide", False, False), ("lean", True, True),
    ("wide", True, True)])
def test_bin_splats_matches(scene250, profile, blown, overflow):
    w, h = 320, 240
    means, scales, quats, opac, shs, cam = _blown(scene250) if blown \
        else scene250
    splats = jpreprocess(means, scales, quats, opac, shs, 3, cam, w, h)
    tx, ty = jb.tile_grid(w, h)
    args = (splats.mean2d, splats.depth, splats.radius, splats.visible)
    want = jb.bin_splats(*args, tx, ty, profile=profile)
    got = tb.bin_splats(*[T(a) for a in args], tx, ty, profile=profile)
    assert bool(want.overflow) == overflow
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for a, b in zip(tb.tile_rect(T(splats.mean2d), T(splats.radius), tx, ty),
                    jb._tile_rect(splats.mean2d, splats.radius, tx, ty)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("w,h,n", [(64, 48, 250), (512, 512, 131072),
                                   (1920, 1080, 1000)])
def test_default_fragment_budget_matches(w, h, n):
    assert tr.default_fragment_budget(w, h, n) == \
        jr.default_fragment_budget(w, h, n)


@pytest.mark.parametrize("profile", ["huge", ("lean", 2), 4096])
def test_legacy_takes_only_its_profiles(scene250, profile):
    means, scales, quats, opac, shs, cam = scene250
    with pytest.raises(KeyError):
        tr.render(T(means), T(shs), T(opac), T(scales), T(quats),
                  tcam_from(cam), binning_mode="legacy",
                  fragment_profile=profile, **RENDER_KW)


def test_legacy_render_matches_jax(scene250):
    kw = dict(RENDER_KW, binning_mode="legacy")
    jout, jgrads = _jax_render_grads(scene250, **kw)
    tout, tgrads = _port_render_grads(scene250, **kw)
    _assert_images(tout, jout)
    for name in ("num_fragments", "overflow", "dropped"):
        assert int(tout[name]) == int(jout[name]), name
    for i, (a, b) in enumerate(zip(jgrads, tgrads)):
        assert_scaled(a, b.numpy(), name=f"grad {i}")


def test_legacy_overflow_reports_dropped():
    """288x48 (18 tiles across): blown spans pass the top tier's 16."""
    means, scales, quats, opac, shs, cam = _blown(make_scene(n=60))
    kw = dict(sh_degree=3, image_width=288, image_height=48,
              binning_mode="legacy")
    jout = jr.render(means, shs, opac, scales, quats, cam, **kw)
    tout = tr.render(T(means), T(shs), T(opac), T(scales), T(quats),
                     tcam_from(cam), **kw)
    assert bool(tout["overflow"]) and int(tout["dropped"]) == -1
    assert int(jout["dropped"]) == -1
    assert int(tout["num_fragments"]) == int(jout["num_fragments"])
    _assert_images(tout, jout)


@pytest.mark.parametrize("include_normal", [True, False])
def test_legacy_equals_compact(scene250, include_normal):
    """Circle rects: the same fragments in the same order, the same tile
    kernels, and the two reductions (index_add_, segsum) sum each
    gaussian's fragments in tile order in float32."""
    kw = dict(RENDER_KW, tight_rect=False, include_normal=include_normal)
    lout, lgrads = _port_render_grads(scene250, binning_mode="legacy", **kw)
    cout, cgrads = _port_render_grads(scene250, binning_mode="compact", **kw)
    assert not bool(cout["overflow"]) and int(cout["dropped"]) == 0
    assert int(lout["num_fragments"]) == int(cout["num_fragments"])
    for k in OUT_KEYS:
        assert torch.equal(lout[k], cout[k]), k
    for i, (a, b) in enumerate(zip(lgrads, cgrads)):
        assert torch.equal(a, b), f"grad {i}"


def test_legacy_order_finds_depth_key_ties():
    """kernel_check.legacy_order, which the card's variants phase runs: a
    gaussian put on another's ray 2e-6 nearer shares its quantized depth
    key, so the compact order (ties in gaussian order) and the legacy order
    (float32 depth) differ in the tiles both cover, and nowhere else."""
    params, cam = KC.random_scene(300, 2, "cpu")
    base = KC.capture_legacy(params, None, cam, 3, 64, 64)
    cap = tc.fragment_capacity(300, "wide")
    assert KC.legacy_order(base, cap)["reordered"].numel() == 0
    xyz = params.xyz.clone()
    xyz[1] = xyz[0] * (1 - 2e-6)
    s = KC.capture_legacy(params._replace(xyz=xyz), None, cam, 3, 64, 64)
    depth = s["splats"].depth
    db = tc.depth_key_bits(4, 4)
    assert depth[1] < depth[0]
    assert tc.quantize_depth_bits(depth[:2], db).unique().numel() == 1
    r = KC.legacy_order(s, cap)
    assert r["reordered"].numel() > 0 and r["tie_pairs"] > 0
    legacy = s["binning"].padded_gid[:r["fragments"]]
    assert torch.equal(legacy[r["order"]].unique(), legacy.unique())


# --------------------------------------------------------------------------
# the render's rules: no process knobs, the tight-rect default, sort bands
# --------------------------------------------------------------------------


# environment variables the render once read at import, each set to a value
# that changed its output then (or, RODYGS_TIGHT_RECT=row, raised)
OLD_KNOBS = {"RODYGS_BWD_UNSORT": "gather", "RODYGS_BF16_RECORDS": "1",
             "RODYGS_FWD_RECORDS": "gather", "RODYGS_TIGHT_RECT": "row",
             "RODYGS_SORT_BANDS": "2"}
_CLEAN_ENV_SCRIPT = """
import importlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import rodygs_tpu_torch.render.rasterize as R
from rodygs_tpu_torch.render.camera import Camera
scene = np.load(sys.argv[1])
KEYS = ("rendered_image", "rendered_depth", "rendered_alpha",
        "rendered_normal", "num_fragments", "dropped")
NAMES = ("means", "scales", "quats", "opac", "shs")

def run():
    leaves = [torch.tensor(scene[k]).requires_grad_(True) for k in NAMES]
    m, s, q, o, sh = leaves
    pose = [torch.tensor(scene[k]).requires_grad_(True) for k in ("q", "t")]
    cam = Camera(*pose, *[torch.tensor(scene[k])
                          for k in ("fovx", "fovy", "time")])
    out = R.render(m, sh, o, s, q, cam, 3, int(scene["W"]), int(scene["H"]))
    (((out["rendered_image"] - 0.3) ** 2).mean()
     + 0.1 * out["rendered_depth"].mean()
     + 0.05 * out["rendered_alpha"].mean()).backward()
    got = {k: out[k].detach() for k in KEYS}
    got.update({n: x.grad for n, x in zip(NAMES + ("q", "t"), leaves + pose)})
    return got

knobbed = run()
for k in [k for k in os.environ if k.startswith("RODYGS_")]:
    del os.environ[k]
importlib.reload(R)
clean = run()
print(json.dumps([k for k in clean if not torch.equal(knobbed[k], clean[k])]))
"""


def test_render_reads_no_process_knobs(scene250, tmp_path):
    """One subprocess renders the scene, forward and backward, with the old
    RODYGS_* render variables set, then again after a re-import in a clean
    environment: every output and gradient keeps its bits."""
    means, scales, quats, opac, shs, cam = scene250
    np.savez(tmp_path / "scene.npz", means=means, scales=scales, quats=quats,
             opac=opac, shs=shs, q=cam.q_c2w, t=cam.t_c2w, fovx=cam.fovx,
             fovy=cam.fovy, time=cam.time, W=W, H=H)
    env = {k: v for k, v in os.environ.items() if not k.startswith("RODYGS_")}
    env.update(OLD_KNOBS, PYTHONPATH=str(REPO))
    res = subprocess.run(
        [sys.executable, "-c", _CLEAN_ENV_SCRIPT, str(tmp_path / "scene.npz")],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("tiles", [12, 1024, 4095, 4096, 8160])
def test_tight_default_decides_as_jax(monkeypatch, tiles):
    """Row spans from 4,096 tiles up, the alpha-AABB below: the JAX
    package's "auto" rule."""
    monkeypatch.setattr(jr, "_TIGHT_ENV", "auto")
    assert tr._default_tight(tiles) == jr._default_tight(tiles) \
        == ("rows" if tiles >= 4096 else True)


@pytest.mark.parametrize("sort_bands,profile,want", [
    (None, ("lean", 2), 2), (1, ("lean", 3), 1), (0, "lean", 1),
    (7, "lean", 3), (None, ("lean", 0), 1), (None, ("lean", 9), 3)])
def test_band_count_clamped(sort_bands, profile, want):
    """sort_bands wins over the profile's count; either lands in [1,
    tiles_y] (3 at 64x48)."""
    assert tr._band_count(profile, sort_bands, 3) == want


def test_forced_zero_bands_renders_one_band(scene250):
    """sort_bands=0 renders one band, as the JAX package's render does,
    whatever the profile's count."""
    means, scales, quats, opac, shs, cam = scene250
    args = (T(means), T(shs), T(opac), T(scales), T(quats), tcam_from(cam))
    with torch.no_grad():
        one = tr.render(*args, **RENDER_KW)
        zero = tr.render(*args, fragment_profile=("lean", 2), sort_bands=0,
                         **RENDER_KW)
    for k in OUT_KEYS:
        assert torch.equal(zero[k], one[k]), k


def test_bands_past_tile_rows_render_as_tile_rows(scene250):
    """sort_bands above tiles_y is clamped to tiles_y: the same outputs and
    gradients, bit for bit."""
    ty = -(-H // 16)
    out, grads = _port_render_grads(scene250, sort_bands=ty, **RENDER_KW)
    over, over_grads = _port_render_grads(scene250, sort_bands=ty + 4,
                                          **RENDER_KW)
    for k in OUT_KEYS:
        assert torch.equal(over[k], out[k]), k
    for i, (a, b) in enumerate(zip(over_grads, grads)):
        assert torch.equal(a, b), f"grad {i}"


# --------------------------------------------------------------------------
# the dense oracle
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sh_degree,bg", [(0, None), (3, (0.2, 0.4, 0.6))])
def test_dense_oracle(scene250, sh_degree, bg):
    """The twin against the JAX oracle, and against the port's render(),
    outputs and gradients (the JAX suite's own check of its render)."""
    means, scales, quats, opac, shs, cam = scene250
    jbg = None if bg is None else jnp.asarray(bg, jnp.float32)
    tbg = None if bg is None else torch.tensor(bg, dtype=torch.float32)
    jsplats = jpreprocess(means, scales, quats, opac, shs, sh_degree, cam, W, H)
    want = jref(jsplats, W, H, bg=jbg)

    def run(use_render):
        leaves = [T(x).requires_grad_(True)
                  for x in (means, scales, quats, opac, shs)]
        m, s, q, o, sh = leaves
        tcam = tcam_from(cam, requires_grad=True)
        if use_render:
            out = tr.render(m, sh, o, s, q, tcam, sh_degree, W, H, bg=tbg)
        else:
            out = tref(tpreprocess(m, s, q, o, sh, sh_degree, tcam, W, H),
                       W, H, bg=tbg)
        _loss_terms(out, 0.3).backward()
        return ({k: v.detach() for k, v in out.items() if k in OUT_KEYS},
                [x.grad for x in leaves] + [tcam.q_c2w.grad, tcam.t_c2w.grad])

    got, ref_grads = run(use_render=False)
    _assert_images(got, want)
    out, grads = run(use_render=True)
    _assert_images(out, got)
    for i, (a, b) in enumerate(zip(ref_grads, grads)):
        assert_scaled(a.numpy(), b.numpy(), name=f"grad {i}")


# --------------------------------------------------------------------------
# the row-sparse camera Adam
# --------------------------------------------------------------------------


def test_sparse_row_adam_matches_jax():
    """Round-robin over F = 4 rows: the JAX trajectory bit for bit, and the
    trajectory of F independent port Adams, each seeing its own visits."""
    F, lr = 4, 0.05
    rng = np.random.default_rng(0)
    p0 = joptim.CameraPoses(*[rng.normal(size=(F, d)).astype(np.float32)
                              for d in (4, 3)])
    grads = [joptim.CameraPoses(*[rng.normal(size=(F, d)).astype(np.float32)
                                  for d in (4, 3)]) for _ in range(12)]
    jp = joptim.CameraPoses(*[jnp.asarray(x) for x in p0])
    tp = toptim.CameraPoses(*[T(x) for x in p0])
    js = joptim.sparse_row_adam_init(jp, F)
    ts = toptim.sparse_row_adam_init(tp, F)
    assert ts.count.dtype == torch.int32 and ts.count.shape == (F,)
    lrs = (lr, 0.5 * lr)
    for i, g in enumerate(grads):
        mask = np.arange(F) == (i % F)
        jp, js = joptim.sparse_row_adam_update(
            joptim.CameraPoses(*[jnp.asarray(x) for x in g]), js, jp,
            joptim.CameraPoses(*lrs), jnp.asarray(mask))
        tp, ts = toptim.sparse_row_adam_update(
            toptim.CameraPoses(*[T(x) for x in g]), ts, tp,
            toptim.CameraPoses(*lrs), torch.tensor(mask))
        for a, b in zip(jax.tree.leaves((jp, js)), toptim.tree_leaves((tp, ts))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in range(F):
        row = toptim.CameraPoses(*[T(x[f]) for x in p0])
        st = toptim.adam_init(row)
        for i, g in enumerate(grads):
            if i % F == f:
                row, st = toptim.adam_update(
                    toptim.CameraPoses(*[T(x[f]) for x in g]), st, row,
                    toptim.CameraPoses(*lrs))
        for a, b in zip(row, tp):
            np.testing.assert_allclose(b[f].numpy(), a.numpy(), rtol=0,
                                       atol=1e-6)


def _static_trainers(n_frames=4):
    store, poses, gt = _bench_like_setup(n_frames=n_frames)
    kw = dict(image_width=W, image_height=H, sh_degree=3,
              densification_interval=0, densify_from_iter=10**9,
              camera_rotation_lr=1e-3, camera_translation_lr=1e-3,
              camera_sparse_adam=True)
    terms = [("l1", 0.8, "L1Loss"), ("d_ssim", 0.2, "SSIMLoss")]
    jtr = jts.ThreeDGSTrainer(jts.StaticTrainerConfig(**kw),
                              jlosses.MultiLoss([jlosses.LossTerm(*t)
                                                 for t in terms]),
                              store, poses, spatial_lr_scale=4.0)
    ttr = tts.ThreeDGSTrainer(tts.StaticTrainerConfig(**kw),
                              tlosses.MultiLoss([tlosses.LossTerm(*t)
                                                 for t in terms]),
                              convert.store_from_numpy(store, "cpu"),
                              convert.poses_from_numpy(poses, "cpu"),
                              spatial_lr_scale=4.0, device="cpu")
    return jtr, ttr, gt


def _batches(gt, frame):
    jbatch = jts.FrameBatch(gt_image=jnp.asarray(gt), gt_depth=None,
                            motion_mask=None, frame_idx=jnp.asarray(frame),
                            time=jnp.asarray(0.0), fovx=jnp.asarray(0.9),
                            fovy=jnp.asarray(0.7))
    tbatch = tts.FrameBatch(gt_image=T(gt), gt_depth=None, motion_mask=None,
                            frame_idx=frame, time=torch.tensor(0.0),
                            fovx=torch.tensor(0.9), fovy=torch.tensor(0.7))
    return jbatch, tbatch


@pytest.fixture(scope="module")
def sparse_trainers():
    """Both packages' static trainers with camera_sparse_adam after one
    train iteration on frame 2."""
    jtr, ttr, gt = _static_trainers()
    jbatch, tbatch = _batches(gt, 2)
    j0, t0 = jtr.state, ttr.state
    jm = jtr.train_iteration(jbatch, 1, jax.random.key(0))
    tm = ttr.train_iteration(tbatch, 1)
    return jtr, ttr, (j0, t0), (jm, tm)


def test_static_step_with_sparse_camera_adam(sparse_trainers):
    jtr, ttr, (j0, t0), (jm, tm) = sparse_trainers
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    js, tsn = jtr.state, ttr.state
    np.testing.assert_array_equal(tsn.cam_opt.count.numpy(), [0, 0, 1, 0])
    np.testing.assert_array_equal(np.asarray(js.cam_opt.count), [0, 0, 1, 0])
    others = [0, 1, 3]
    for name in ("q_c2w", "t_c2w"):
        before = getattr(t0.poses, name).numpy()
        after = getattr(tsn.poses, name).numpy()
        np.testing.assert_array_equal(after[others], before[others])
        assert np.abs(after[2] - before[2]).max() > 0
        for tree in ("mu", "nu"):
            jmom = np.asarray(getattr(getattr(js.cam_opt, tree), name))
            tmom = getattr(getattr(tsn.cam_opt, tree), name).numpy()
            assert not tmom[others].any()
            assert_scaled(jmom[2], tmom[2], name=f"{tree}.{name}")
        # the first Adam step is +-lr on every component whose gradient
        # is not tiny: compare where the moment is
        mu = np.asarray(getattr(js.cam_opt.mu, name))[2]
        mask = np.abs(mu) > 1e-3 * np.abs(mu).max()
        np.testing.assert_allclose(
            after[2][mask], np.asarray(getattr(js.poses, name))[2][mask],
            rtol=1e-6, atol=1e-7)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def test_sparse_adam_resume_crosses_packages(sparse_trainers, tmp_path):
    jtr, ttr, _, _ = sparse_trainers
    jjoint = jtj.RoDyGSTrainer(jtr, None)
    tjoint = ttj.RoDyGSTrainer(ttr, None)
    jjoint.save_resume(tmp_path / "jax.ckpt", 1, jax.random.key(3))
    # the port's state moves away first, so the load is seen to act
    saved = ttr.state
    ttr.state = saved._replace(cam_opt=saved.cam_opt._replace(
        count=saved.cam_opt.count + 5))
    assert tjoint.load_resume(tmp_path / "jax.ckpt") == 2
    assert ttr.state.cam_opt.count.dtype == torch.int32
    np.testing.assert_array_equal(ttr.state.cam_opt.count.numpy(),
                                  [0, 0, 1, 0])
    for a, b in zip(_leaves(jtr.state),
                    [x.numpy() for x in toptim.tree_leaves(ttr.state)]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)

    ttr.state = ttr.state._replace(cam_opt=ttr.state.cam_opt._replace(
        count=torch.tensor([3, 1, 4, 1], dtype=torch.int32)))
    cam_np = convert.adam_to_numpy(ttr.state.cam_opt)
    np.testing.assert_array_equal(cam_np["count"], [3, 1, 4, 1])
    back = convert.adam_from_numpy(cam_np, toptim.CameraPoses, device="cpu")
    assert torch.equal(back.count, ttr.state.cam_opt.count)
    tjoint.save_resume(tmp_path / "port.ckpt", 7)
    nxt, _ = jjoint.load_resume(tmp_path / "port.ckpt")
    assert nxt == 8
    np.testing.assert_array_equal(np.asarray(jtr.state.cam_opt.count),
                                  [3, 1, 4, 1])
    for a, b in zip(_leaves(jtr.state),
                    [x.numpy() for x in toptim.tree_leaves(ttr.state)]):
        np.testing.assert_array_equal(a, b)
