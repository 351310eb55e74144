"""The port's tools (`rodygs_tpu_torch/tools/`) against the JAX package's
`scripts/`, on the CPU at small sizes.

  * flagship_1080p: the scene draws and the pose noise equal to the JAX
    script's (quaternions 1e-7), the GT stores equal to the JAX package's;
    the GT render with its escalation loop at 64x48 / 300 + 300 gaussians
    against the JAX package's `render` on its own stores (image 2e-5,
    depth 2e-4, the same escalation decisions); the motion mask at 2,000
    dynamic gaussians (equal but within 1e-5 of the 0.3 threshold); one pre-alignment level
    of 5 steps against the same loop over the JAX package's
    `render(pose_grad_only=True)` and `adam_update` (the first step's
    gradient 5e-4 of its max, the losses 1e-5 relative); the whole tool,
    cut after its snapshot at 3 and resumed at 4: the JAX script's result
    keys, finite values, no drops;
  * mast3r_unproject and mast3r_driver: the same files as the JAX scripts
    from the same inputs, the driver's functions equal over a grid;
  * convert_reference_ckpt: the JAX converter's arrays, files read by both
    packages' loaders, and the port's eval CLI on the converted run;
  * profile_step --no_trace: its `[steady]` line parses with
    `scripts/ab_report.py`'s regex; img2video: a readable video;
  * every tool module imports and answers --help with JAX and the JAX
    package refused at import (the multi-device and sort tools too; their
    parity tests are in tests/test_torch_scaling.py).

torch runs on one thread here (see tests/test_torch_pipeline.py).
"""

import ast
import json
import pickle
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.ops.quaternion import quat_multiply as jquat_multiply
from rodygs_tpu.render.camera import make_camera as jmake_camera
from rodygs_tpu.render.compact import profile_for_demand as jprofile_for_demand
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu.train.optim import adam_init as jadam_init
from rodygs_tpu.train.optim import adam_update as jadam_update
from rodygs_tpu.utils import checkpoint as jckpt
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.pipelines import eval as teval_cli
from rodygs_tpu_torch.tools import convert_reference_ckpt as tconv
from rodygs_tpu_torch.tools import flagship_1080p as FT
from rodygs_tpu_torch.tools import mast3r_driver as tdriver
from rodygs_tpu_torch.tools import mast3r_unproject as tunproj
from rodygs_tpu_torch.tools import profile_step as tprof
from rodygs_tpu_torch.utils import checkpoint as tckpt
from rodygs_tpu_torch.utils.ply import read_ply

from test_convert_ckpt import _reference_style_ckpt
from test_pipeline import scene_dir, train_config  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import ab_report  # noqa: E402
import convert_reference_ckpt as jconv  # noqa: E402
import mast3r_driver as jdriver  # noqa: E402
import mast3r_unproject as junproj  # noqa: E402

W, H, N = 64, 48, 300
IMG_TOL, DEPTH_TOL, GRAD_TOL = 2e-5, 2e-4, 5e-4
TOOLS = ("flagship_1080p", "profile_step", "mast3r_unproject",
         "mast3r_driver", "run_mast3r", "convert_reference_ckpt",
         "img2video", "scaling_bench", "measure_dyn_replication",
         "multihost_smoke", "sort_microbench", "bench")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# flagship_1080p
# --------------------------------------------------------------------------


def jax_flagship_draws(n, rot_deg, trans_sigma):
    """The numpy draws of `scripts/flagship_1080p.py` in its order (:95-117,
    :198-203, :366-377), the pose noise through the JAX package's
    `quat_multiply`."""
    rng = np.random.default_rng(13)
    d = {}
    d["sm"] = rng.uniform([-4.0, -2.5, 2.5], [4.0, 2.5, 9.0],
                          size=(n, 3)).astype(np.float32)
    d["s_scales"] = np.exp(rng.uniform(-5.2, -3.8, size=(n, 3))).astype(np.float32)
    d["s_cols"] = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    d["dm0"] = rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 6.0],
                           size=(n, 3)).astype(np.float32)
    d["d_scales"] = np.exp(rng.uniform(-5.2, -4.0, size=(n, 3))).astype(np.float32)
    d["d_cols"] = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    d["vel"] = rng.uniform(-0.25, 0.25, size=(n, 3)).astype(np.float32)
    poses = []
    for ang in np.linspace(-0.18, 0.18, 12):
        poses.append((np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0],
                               np.float32),
                      np.array([np.sin(ang) * 5.0, 0.0, 0.0], np.float32)))
    d["sm_init"] = d["sm"] + rng.normal(0, 0.01, d["sm"].shape).astype(np.float32)
    birth = rng.integers(0, 12, size=n)
    d["birth_t"] = (birth / 11).astype(np.float32)
    d["dm_init"] = (d["dm0"] + d["vel"] * d["birth_t"][:, None]
                    + rng.normal(0, 0.01, d["dm0"].shape)).astype(np.float32)
    gt_q = np.stack([p[0] for p in poses])
    gt_t = np.stack([p[1] for p in poses])
    half = np.deg2rad(rot_deg) / 2.0
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dq = np.concatenate([np.full((12, 1), np.cos(half)),
                         np.sin(half) * axes], axis=1).astype(np.float32)
    init_q = np.asarray(jquat_multiply(jnp.asarray(dq), jnp.asarray(gt_q)))
    init_t = (gt_t + rng.normal(0, trans_sigma, gt_t.shape)).astype(np.float32)
    return d, gt_q, gt_t, init_q, init_t


def jax_gt_store(xyz, scales, cols, cap):
    """The JAX script's `gt_store` (:118-123)."""
    st = JG.from_point_cloud(xyz, cols, sh_degree=3, capacity=cap)
    return st._replace(params=st.params._replace(scaling=jnp.asarray(np.log(
        np.pad(scales, ((0, cap - xyz.shape[0]), (0, 0)),
               constant_values=1e-6)))))


@pytest.fixture(scope="module")
def flagship_scene():
    rng = np.random.default_rng(13)
    scene = FT.make_scene(N, rng, W, H, device="cpu")
    noise = FT.perturb_poses(scene.gt_q, scene.gt_t, rng, 0.5, 0.025)
    return scene, noise


def test_flagship_scene_matches_jax_draws(flagship_scene):
    scene, (init_q, init_t) = flagship_scene
    d, gt_q, gt_t, jq, jt = jax_flagship_draws(N, 0.5, 0.025)
    assert sorted(scene.draws) == sorted(d)
    for k, v in d.items():
        np.testing.assert_array_equal(scene.draws[k], v, err_msg=k)
    np.testing.assert_array_equal(scene.gt_q, gt_q)
    np.testing.assert_array_equal(scene.gt_t, gt_t)
    np.testing.assert_allclose(init_q, jq, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(init_t, jt)
    # the stores the JAX script builds from these arrays
    cap_gt, cap_tr = FT.capacities(N)
    for port, (xyz, scales, cols, cap, times) in (
            (scene.gt_static, (d["sm"], d["s_scales"], d["s_cols"], cap_gt,
                               None)),
            (scene.dynamic_init, (d["dm_init"], d["d_scales"] * 2.5,
                                  d["d_cols"], cap_tr, d["birth_t"]))):
        js = JG.from_point_cloud(xyz, cols, sh_degree=3, capacity=cap,
                                 times=times)
        assert TG.capacity_of(port) == cap
        for name in ("xyz", "features_dc", "features_rest", "rotation",
                     "opacity"):
            np.testing.assert_allclose(getattr(port.params, name).numpy(),
                                       np.asarray(getattr(js.params, name)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_array_equal(port.params.scaling.numpy(), np.log(
            np.pad(scales, ((0, cap - N), (0, 0)), constant_values=1e-6)))
        for name in ("alive", "time", "time_ind"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(js, name)))


def _jax_render_gt(d, cam, t, profile, cap_gt):
    """The JAX script's `render_gt` (:135-163) on the JAX package's stores;
    returns (image, depth, the profiles tried)."""
    gs = jax_gt_store(d["sm"], d["s_scales"], d["s_cols"], cap_gt)
    gd = jax_gt_store(d["dm0"], d["d_scales"], d["d_cols"], cap_gt)
    sp, dp = gs.params, gd.params
    dyn_xyz = dp.xyz + jnp.pad(jnp.asarray(d["vel"] * t),
                               ((0, cap_gt - N), (0, 0)))
    profiles = [profile]
    while True:
        out = jrender(
            jnp.concatenate([sp.xyz, dyn_xyz]),
            jnp.concatenate([JG.get_features(sp), JG.get_features(dp)]),
            jnp.concatenate([JG.get_opacity(sp), JG.get_opacity(dp)]),
            jnp.concatenate([JG.get_scaling(sp), JG.get_scaling(dp)]),
            jnp.concatenate([sp.rotation, dp.rotation]), cam, 3, W, H,
            alive=jnp.concatenate([gs.alive, gd.alive]),
            fragment_profile=profiles[-1])
        if not bool(out["overflow"]):
            break
        profiles.append(jprofile_for_demand(2 * cap_gt,
                                            int(out["num_fragments"]),
                                            profiles[-1]))
    return (np.asarray(jnp.clip(out["rendered_image"], 0.0, 1.0)),
            np.asarray(out["rendered_depth"]), profiles)


def test_flagship_gt_render_matches_jax(flagship_scene):
    scene, _ = flagship_scene
    cap_gt, _ = FT.capacities(N)
    i = 3
    t = FT.frame_time(i)
    start = 512     # below the demand: the loop must escalate
    img, depth, tried = FT.render_gt(scene, FT.frame_camera(scene, i), t,
                                     start)
    jcam = jmake_camera(scene.gt_q[i], scene.gt_t[i], FT.FOVX, FT.FOVY,
                        time=t)
    jimg, jdepth, jtried = _jax_render_gt(scene.draws, jcam, t, start, cap_gt)
    assert tried == jtried and len(tried) > 1
    np.testing.assert_allclose(img.numpy(), jimg, atol=IMG_TOL)
    np.testing.assert_allclose(depth.numpy(), jdepth, atol=DEPTH_TOL)


def test_flagship_dynamic_mask_matches_jax():
    """At 2,000 gaussians a frame: at 300 no pixel of 64x48 reaches the
    threshold (the GT opacities are 0.1)."""
    n, i = 2000, 3
    scene = FT.make_scene(n, np.random.default_rng(13), W, H, device="cpu")
    t = FT.frame_time(i)
    mask = FT.dynamic_mask(scene, FT.frame_camera(scene, i), t, "wide")
    # the JAX script's `render_dyn_alpha` (:165-175)
    d = scene.draws
    cap_gt, _ = FT.capacities(n)
    gd = jax_gt_store(d["dm0"], d["d_scales"], d["d_cols"], cap_gt)
    dp = gd.params
    dyn_xyz = dp.xyz + jnp.pad(jnp.asarray(d["vel"] * t),
                               ((0, cap_gt - n), (0, 0)))
    alpha = np.asarray(jrender(
        dyn_xyz, JG.get_features(dp), JG.get_opacity(dp), JG.get_scaling(dp),
        dp.rotation, jmake_camera(scene.gt_q[i], scene.gt_t[i], FT.FOVX,
                                  FT.FOVY, time=t), 3, W, H,
        alive=gd.alive, fragment_profile="wide")["rendered_alpha"])
    want = (alpha > 0.3).astype(np.float32)
    far = np.abs(alpha - 0.3) > 1e-5
    np.testing.assert_array_equal(mask.numpy()[far], want[far])
    assert want.sum() > 0 and far.mean() > 0.99


def test_flagship_prealign_level_matches_jax(flagship_scene):
    scene, (init_q, init_t) = flagship_scene
    i, f, steps, lr = 2, 4, 5, 4e-3
    cam = FT.frame_camera(scene, i)
    image, _, _ = FT.render_gt(scene, cam, FT.frame_time(i), "wide")
    mask = torch.zeros(H, W)
    mask[10:30, 20:44] = 1.0    # a motion mask the pooled keep-mask shrinks
    store = scene.static_init
    q, t, losses, (gq, gt_) = FT.prealign_level(
        store, torch.tensor(init_q[i]), torch.tensor(init_t[i]), image, mask,
        f, steps, lr, W, H)

    # the JAX script's level (:239-279) over the same store and GT
    args = [jnp.asarray(a.numpy()) for a in TG.active_arrays(store)]
    gt = jnp.asarray(image.numpy())
    m = jnp.asarray(mask.numpy())

    def pool(img):
        hh, ww = img.shape[0] // f, img.shape[1] // f
        if img.ndim == 2:
            return img.reshape(hh, f, ww, f).mean((1, 3))
        return img.reshape(hh, f, ww, f, img.shape[-1]).mean((1, 3))

    gt_l = pool(gt)
    keep = 1.0 - (pool(m) > 0.25 / (f * f))

    def loss_fn(q, t):
        cam = jmake_camera(q, t, FT.FOVX, FT.FOVY, 0.0)
        out = jrender(*args[:5], cam, 3, W, H, alive=args[5],
                      fragment_profile="wide", include_normal=False,
                      pose_grad_only=True)
        pred = pool(jnp.clip(out["rendered_image"], 0.0, 1.0))
        return jnp.mean(jnp.abs((pred - gt_l) * keep[..., None]))

    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    pose = (jnp.asarray(init_q[i]), jnp.asarray(init_t[i]))
    opt = jadam_init(pose)
    jlosses, jgrads = [], None
    for _ in range(steps):
        loss, grads = vg(*pose)
        jgrads = grads if jgrads is None else jgrads
        jlosses.append(float(loss))
        pose, opt = jadam_update(grads, opt, pose, lr)
    for a, b in ((jgrads[0], gq), (jgrads[1], gt_)):
        a = np.asarray(a, np.float64)
        scale = np.abs(a).max()
        assert scale > 0
        np.testing.assert_allclose(b.numpy() / scale, a / scale, atol=GRAD_TOL)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5)
    assert jlosses[-1] < jlosses[0]
    np.testing.assert_allclose(q.numpy(), np.asarray(pose[0]), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(pose[1]), atol=1e-5)


def _jax_result_keys():
    """The keys of the JAX script's result dict (:744-776), read from its
    source, with those of its `mem` dict (:704-733)."""
    tree = ast.parse((REPO / "scripts" / "flagship_1080p.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and getattr(node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys if k is not None}
        if isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "mem" and isinstance(
                node.slice, ast.Constant):
            keys.add(node.slice.value)
    assert "psnr_holdout_view" in keys and "peak_hbm_gb" in keys
    return keys


def test_flagship_tool_runs_and_resumes(tmp_path, monkeypatch):
    state = tmp_path / "state"
    argv = ["--device", "cpu", "--width", str(W), "--height", str(H), "--n",
            str(N), "--iters", "6", "--resume_every", "3", "--log_every", "2",
            "--state_dir", str(state), "--pose_noise_rot_deg", "0.5",
            "--pose_noise_trans", "0.025", "--pose_prealign",
            "--prealign_steps", "1", "--motion_masks", "--eval_w_align",
            "--w_align_steps", "2", "--out", str(tmp_path / "r.json")]
    args = FT.build_parser().parse_args(argv)
    assert args.state_dir == str(state)
    assert FT.build_parser().parse_args([]).out is None
    iteration = FT.RoDyGSTrainer.train_iteration

    class Cut(Exception):
        pass

    def crash_at_5(self, sb, db, it):
        if it == 5:
            raise Cut
        return iteration(self, sb, db, it)

    monkeypatch.setattr(FT.RoDyGSTrainer, "train_iteration", crash_at_5)
    with pytest.raises(Cut):
        FT.main(args)
    assert (state / "resume.ckpt").exists()
    assert json.loads((state / "resume_sidecar.json").read_text())[
        "iteration"] == 3
    monkeypatch.setattr(FT.RoDyGSTrainer, "train_iteration", iteration)
    res = FT.main(args)
    assert res == json.loads((tmp_path / "r.json").read_text())
    assert _jax_result_keys() | {"device", "loss_traj",
                                 "dropped_eval_at_train_profile"} == set(res)
    assert res["resumed_from"] == 3 and res["device"] == "cpu"
    assert res["dropped_final"] == [0, 0] and res["dropped_eval"] == [0, 0]
    assert [int(v) for v in res["dropped_eval_at_train_profile"]] == \
        res["dropped_eval_at_train_profile"]
    assert [a[0] for a in res["alive_traj"]] == [2, 4, 6]
    for k in ("step_ms_median", "mpix_per_s_fwd_bwd", "psnr_train_view",
              "psnr_holdout_view", "train_wall_s"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert all(np.isfinite(v) for row in res["loss_traj"] for v in row)
    assert res["peak_hbm_gb"] is None
    assert set(res["fragment_demand_static_view0"]) == {"loose", "tight",
                                                        "rows"}
    pn = res["pose_noise"]
    assert {"init_scores", "prealign", "prealign_scores", "final_scores",
            "ate_traj"} <= set(pn)
    assert np.isfinite(pn["final_scores"]["ATE"])
    wa = res["eval_w_align"]
    assert wa["num_opts"] == 2 and np.isfinite(wa["psnr_aligned"])


# --------------------------------------------------------------------------
# MASt3R unprojection and driver
# --------------------------------------------------------------------------


def _unproject_scene(root, with_masks=True):
    """`tests/test_scripts.py:62-105`'s scene under `root`."""
    h, w, n_frames = 24, 32, 3
    exp = root / "mast3r_opt" / "exp0"
    exp.mkdir(parents=True)
    (root / "train").mkdir()
    (root / "tam_mask").mkdir()
    rng = np.random.default_rng(0)
    depths = rng.uniform(0.3, 1.0, size=(n_frames, h * w)).astype(np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    c2ws[:, :3, 3] = rng.normal(size=(n_frames, 3))
    with open(exp / "global_params.pkl", "wb") as f:
        pickle.dump({"focals": [30.0], "cam2worlds": c2ws, "depths": depths,
                     "max_depths": [4.0],
                     "masks": np.ones((n_frames, h, w), bool)}, f)
    imagepaths, maskpaths = [], []
    for i in range(n_frames):
        img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
        p = root / "train" / f"rgb_{i:05d}.png"
        Image.fromarray(img).save(p)
        imagepaths.append(str(p))
        mask = np.zeros((h, w), np.uint8)
        mask[:, w // 2:] = 255 if with_masks else 0
        mp = root / "tam_mask" / f"{i:06d}.png"
        Image.fromarray(mask).save(mp)
        maskpaths.append(str(mp))
    return exp, imagepaths, maskpaths


def _same_trees(a: Path, b: Path, skip=()):
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for rel in names:
        if rel.suffix == ".ply":
            ra, rb = read_ply(a / rel), read_ply(b / rel)
            assert list(ra) == list(rb), rel
            for k in ra:
                np.testing.assert_array_equal(rb[k], ra[k], err_msg=str(rel))
        elif rel.suffix == ".npy":
            np.testing.assert_array_equal(np.load(b / rel), np.load(a / rel))
        elif rel.suffix != ".pkl" and rel.name not in skip:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    return names


@pytest.mark.parametrize("with_masks", [True, False])
def test_mast3r_unproject_matches_jax(tmp_path, with_masks):
    outs = []
    for name, mod in (("jax", junproj), ("port", tunproj)):
        exp, images, masks = _unproject_scene(tmp_path / name, with_masks)
        skip = mod.check_all_masks_false(masks)
        assert skip == (not with_masks)
        mod.mast3r_unprojection(str(exp), masks, images, skip_dynamic=skip)
        outs.append(exp)
    names = _same_trees(*outs)
    assert any(n.parts[0] == "dynamic" for n in names) == with_masks
    pts = read_ply(outs[1] / "static" / "0000_static.ply")
    assert len(pts["x"]) == (24 * 32 // 2 if with_masks else 24 * 32)


def test_mast3r_driver_functions_match_jax():
    for n in (2, 3, 5, 9, 16):
        for kind in ("swin", "logwin", "oneref"):
            for cyc in (False, True):
                for win in (1, 2, 3, 10, 100):
                    assert tdriver.clamp_winsize(n, kind, cyc, win) == \
                        jdriver.clamp_winsize(n, kind, cyc, win)
                    for sym in (False, True):
                        assert tdriver.build_pair_graph(
                            n, kind, win, cyc, refid=1, symmetrize=sym) == \
                            jdriver.build_pair_graph(n, kind, win, cyc,
                                                     refid=1, symmetrize=sym)
                    assert tdriver.scene_graph_string(kind, win, cyc, 1) == \
                        jdriver.scene_graph_string(kind, win, cyc, 1)
    with pytest.raises(ValueError):
        tdriver.build_pair_graph(4, "nope")
    for t in np.linspace(-0.5, 1.5, 21):
        assert tdriver.cosine_lr(t, 0.07, 0.001) == jdriver.cosine_lr(
            t, 0.07, 0.001)
    for level in ("coarse", "refine", "refine+depth"):
        kw = dict(lr1=0.05, niter1=7, lr2=0.01, niter2=3, optim_level=level)
        assert tdriver.TwoStageSchedule(**kw).stages() == \
            jdriver.TwoStageSchedule(**kw).stages()

    class Backend:
        def __init__(self):
            self.trace = []

        def prepare(self, pairs):
            self.trace.append(("prepare", tuple(pairs)))

        def step(self, stage, lr, opt_depth):
            self.trace.append((stage, lr, opt_depth))

        def finalize(self):
            return self.trace

    sched = dict(lr1=0.07, niter1=6, lr2=0.014, niter2=4)
    got = tdriver.run_two_stage_alignment(
        Backend(), [(0, 1)], tdriver.TwoStageSchedule(**sched),
        log=lambda *_: None)
    assert got == jdriver.run_two_stage_alignment(
        Backend(), [(0, 1)], jdriver.TwoStageSchedule(**sched),
        log=lambda *_: None)


def _mock_scene(n=3, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(size=(h, w, 3)).astype(np.float32) for _ in range(n)]
    depths = [rng.uniform(1.0, 5.0, size=(h, w)).astype(np.float32)
              for _ in range(n)]
    pts = [rng.normal(size=(h * w, 3)).astype(np.float32) for _ in range(n)]
    pts[1][5] = np.nan     # a non-finite point is filtered out
    confs = [rng.uniform(0.0, 3.0, size=(h, w)).astype(np.float32)
             for _ in range(n)]
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    c2ws[:, 0, 3] = np.arange(n)

    class MockScene:
        def __init__(self):
            self.imgs = imgs

        def get_focals(self):
            return torch.tensor([30.0])

        def get_im_poses(self):
            return torch.from_numpy(c2ws)

        def get_dense_pts3d(self, clean_depth=True):
            return pts, depths, confs

    return MockScene()


def test_mast3r_driver_export_matches_jax(tmp_path):
    geo_j = jdriver.collect_geometry(_mock_scene(), 1.5)
    geo_t = tdriver.collect_geometry(_mock_scene(), 1.5)
    for a, b in zip(geo_j, geo_t):
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        else:
            np.testing.assert_array_equal(b, a)
    got = {}
    for name, mod in (("jax", jdriver), ("port", tdriver)):
        got[name] = mod.run_driver(_mock_scene(), tmp_path / name,
                                   min_conf_thr=1.5)
    _same_trees(tmp_path / "jax", tmp_path / "port")
    for rel in ["global_params.pkl"] + [f"op_results/pointcloud_{i:04d}.pkl"
                                        for i in range(3)]:
        with open(tmp_path / "jax" / rel, "rb") as f:
            a = pickle.load(f)
        with open(tmp_path / "port" / rel, "rb") as f:
            b = pickle.load(f)
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "pointcloud_paths":
                assert [Path(p).name for p in b[k]] == [Path(p).name
                                                        for p in a[k]]
            else:
                np.testing.assert_array_equal(np.asarray(b[k]),
                                              np.asarray(a[k]), err_msg=k)
    assert sorted(got["jax"]) == sorted(got["port"])
    with pytest.raises(ValueError):
        tdriver.export_geometry(tmp_path / "bad", *geo_t[:2], geo_t[2][:1],
                                *geo_t[3:])


# --------------------------------------------------------------------------
# convert_reference_ckpt
# --------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_convert_reference_ckpt_matches_jax_and_evaluates(
        tmp_path, scene_dir, train_config):  # noqa: F811
    ref = tmp_path / "ref" / "train"
    ref.mkdir(parents=True)
    n_frames = 5    # the scene_dir fixture's frames
    sds = {}
    for name, seed in (("static_last.ckpt", 0), ("dynamic_last.ckpt", 3)):
        sd, _, _ = _reference_style_ckpt(seed=seed)
        sd["active_sh_degree"] = 1
        sd["model"]["_features_rest"] = sd["model"]["_features_rest"][:, :3]
        sd["camera"] = {k: v[:n_frames] for k, v in sd["camera"].items()}
        if name == "static_last.ckpt":
            for k in ("_motion_coeff", "_deform_network", "_timestep"):
                del sd["model"][k]
        sds[name] = sd
        torch.save((sd, 1234), ref / name)
    cfg = json.loads(json.dumps(train_config))
    cfg["dynamic_model"]["params"]["deform_t_emb_multires"] = 5
    (ref / "config.yaml").write_text(yaml.dump(cfg))

    out = tmp_path / "converted"
    tconv.main(["--modeldir", str(tmp_path / "ref"), "--outdir", str(out),
                "--capacity_factor", "1.5"])
    for name, sd in sds.items():
        want = jconv.convert_checkpoint(sd, 1234, 1.5)
        if name == "dynamic_last.ckpt":
            want["inverse_motion"] = True
        assert _flat(tconv.convert_checkpoint(sd, 1234, 1.5)).keys() == \
            _flat(jconv.convert_checkpoint(sd, 1234, 1.5)).keys()
        for loader in (tckpt.load_checkpoint, jckpt.load_checkpoint):
            got, it = loader(out / "train" / name)
            assert it == 1234
            fw, fg = _flat(want), _flat(got)
            assert fw.keys() == fg.keys(), name
            for k, v in fw.items():
                np.testing.assert_array_equal(np.asarray(fg[k]),
                                              np.asarray(v), err_msg=k)
    assert (out / "train" / "config.yaml").read_text() == \
        (ref / "config.yaml").read_text()

    res = teval_cli.main(["-c", str(REPO / "configs" / "eval" /
                                    "eval_wo_align.yaml"),
                          "-d", str(scene_dir), "-m", str(out),
                          "--device", "cpu"])
    assert np.isfinite(res["viz"]["psnr"]) and np.isfinite(res["pose"]["ATE"])
    assert (out / "eval" / "result.yaml").exists()


# --------------------------------------------------------------------------
# profile_step, img2video, imports
# --------------------------------------------------------------------------


def test_profile_step_no_trace_prints_the_steady_line(capsys):
    args = tprof.build_parser().parse_args([
        "--device", "cpu", "--width", "64", "--height", "64", "--n", "400",
        "--steps", "2", "--windows", "2", "--no_trace"])
    ms = tprof.main(args)
    out = capsys.readouterr().out
    m = list(ab_report.STEADY.finditer(out))
    assert len(m) == 1 and float(m[0].group(1)) == pytest.approx(ms, abs=0.06)
    assert m[0].group(3) is not None and int(m[0].group(4)) > 0
    assert float(m[0].group(2)) > 0


def test_img2video_writes_a_readable_video(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        cv2.imwrite(str(frames / f"{i:03d}.png"),
                    (rng.uniform(size=(32, 48, 3)) * 255).astype(np.uint8))
    video = tmp_path / "v.mp4"
    res = subprocess.run(
        [sys.executable, "-m", "rodygs_tpu_torch.tools.img2video",
         "--input_dir", str(frames), "--output", str(video), "--fps", "5"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    cap = cv2.VideoCapture(str(video))
    n = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        assert img.shape == (32, 48, 3)
        n += 1
    cap.release()
    assert n == 6


_NO_JAX = """
import contextlib, importlib.abc, io, runpy, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "rodygs_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
for name in sys.argv[1:]:
    out = io.StringIO()
    sys.argv = [name, "--help"]
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(name, run_name="__main__")
            code = None
        except SystemExit as e:
            code = e.code
    print("=== " + name + " exit " + repr(code))
    print(out.getvalue())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "rodygs_tpu")]
print("=== modules " + repr(bad))
"""


@pytest.fixture(scope="module")
def help_without_jax():
    """Every tool's --help in one subprocess that refuses to import JAX and
    the JAX package: {module: (exit code, stdout)}."""
    names = [f"rodygs_tpu_torch.tools.{t}" for t in TOOLS]
    res = subprocess.run([sys.executable, "-c", _NO_JAX, *names], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    parts = res.stdout.split("=== ")[1:]
    assert parts[-1].strip() == "modules []", parts[-1]
    out = {}
    for part in parts[:-1]:
        head, _, body = part.partition("\n")
        name, _, code = head.partition(" exit ")
        out[name] = (code, body)
    return out


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax_and_answers_help(help_without_jax, tool):
    name = f"rodygs_tpu_torch.tools.{tool}"
    code, text = help_without_jax[name]
    assert code == "0" and "usage: python -m " + name in text, (code, text)


def test_tools_need_a_card_or_the_cpu_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (FT, tprof):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(mod.build_parser().parse_args([]))
    from rodygs_tpu_torch.tools import run_mast3r

    # the external network is absent here: the runner says so
    with pytest.raises(SystemExit, match="MASt3R is an external dependency"):
        run_mast3r.main(str(tmp_path), "x", "model", device="cpu")
