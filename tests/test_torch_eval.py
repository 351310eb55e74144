"""The port's evaluator against the JAX package's on the CPU.

The same numpy-seeded inputs go through `rodygs_tpu.evalsuite` and
`rodygs_tpu_torch.evalsuite`: image metrics (1e-5 absolute), LPIPS on
seeded random weights (1e-5 relative), pose metrics (1e-6), the pure
helpers (equal), checkpoints in both directions (arrays equal), test-time
pose optimisation (1e-6 absolute) and the whole `RoDyGSEvaluator.eval()`
with and without alignment on the same checkpoint files and the same
in-memory datamodule (viz 1e-4, pose 1e-6, PNGs within 2 of 65535, the same
result.yaml structure).
"""

import json
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rodygs_tpu.evalsuite import evaluator as jev
from rodygs_tpu.evalsuite import lpips as jlpips
from rodygs_tpu.evalsuite import metrics as jmet
from rodygs_tpu.evalsuite import pose_metrics as jpm
from rodygs_tpu.evalsuite import pose_opt as jpo
from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.ops import image as jimage
from rodygs_tpu.render.camera import make_camera as jmake_camera
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_dynamic as jtd
from rodygs_tpu.train import trainer_joint as jtj
from rodygs_tpu.train import trainer_static as jts
from rodygs_tpu.utils import checkpoint as jckpt
from rodygs_tpu.utils import store as jstore
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.evalsuite import evaluator as tev
from rodygs_tpu_torch.evalsuite import lpips as tlpips
from rodygs_tpu_torch.evalsuite import metrics as tmet
from rodygs_tpu_torch.evalsuite import pose_metrics as tpm
from rodygs_tpu_torch.evalsuite import pose_opt as tpo
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.ops import image as timage
from rodygs_tpu_torch.render.camera import make_camera as tmake_camera
from rodygs_tpu_torch.render.compact import fragment_capacity
from rodygs_tpu_torch.render.rasterize import render as trender
from rodygs_tpu_torch.train import losses as tlosses
from rodygs_tpu_torch.train import trainer_dynamic as ttd
from rodygs_tpu_torch.train import trainer_joint as ttj
from rodygs_tpu_torch.train import trainer_static as tts
from rodygs_tpu_torch.train.optim import AdamState
from rodygs_tpu_torch.utils import checkpoint as tckpt
from rodygs_tpu_torch.utils import store as tstore

import test_eval
from test_torch_dynamic import _flat, _jax_store

W, H = 64, 48
N_STATIC, N_DYN, CAP_S, CAP_D = 300, 100, 384, 128
FOV = 0.9


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _pair(seed, shape):
    a = _img(seed, shape)
    b = np.clip(a + np.random.default_rng(seed + 1).normal(0, 0.08, shape),
                0, 1).astype(np.float32)
    return a, b


# --------------------------------------------------------------------------
# image metrics and LPIPS
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(192, 176, 3), (48, 64, 3), (33, 45, 3),
                                   (16, 16, 3), (9, 12, 1)])
def test_image_metrics_match(shape):
    """5 levels at 192x176; fewer, odd sizes (edge padding) and tiny ones."""
    a, b = _pair(shape[0], shape)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.tensor(a), torch.tensor(b)
    assert tmet.ms_ssim_levels(*shape[:2]) == jmet.ms_ssim_levels(*shape[:2])
    pairs = [(timage.psnr(tb, ta), jimage.psnr(jb, ja))]
    if min(shape[:2]) >= 11:
        pairs += [(tmet.ssim_eval(ta, tb), jmet.ssim_eval(ja, jb)),
                  (tmet.ms_ssim(ta, tb), jmet.ms_ssim(ja, jb))]
    for got, want in pairs:
        assert np.isfinite(float(got))
        np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    np.testing.assert_allclose(tmet._downsample2(ta).numpy(),
                               np.asarray(jmet._downsample2(ja)), atol=1e-7)


def test_viz_score_matches():
    a, b = _pair(7, (48, 64, 3))
    b[0, 0] = 1.3     # the scores clip to [0, 1]
    got = tmet.VizScoreEvaluator(None, device="cpu").get_score(a, b)
    want = jmet.VizScoreEvaluator(None).get_score(a, b)
    assert set(got) == set(want) == {"psnr", "ssim", "msssim", "dssim"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches(net, tmp_path):
    rng = np.random.default_rng(3 if net == "alex" else 4)
    path, _ = test_eval.TestLpipsParity._make_weights(net, tmp_path, rng)
    h, w = (80, 96) if net == "alex" else (64, 64)
    img1 = rng.uniform(size=(h, w, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 0.1, img1.shape), 0, 1).astype(
        np.float32)
    got = float(tlpips.lpips_fn(net, path, device="cpu")(img1, img2))
    want = float(jlpips.lpips_fn(net, path)(img1, img2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(tlpips.lpips_fn(net, path, "cpu")(img1, img1)) == \
        pytest.approx(0.0, abs=1e-6)


def test_viz_score_with_lpips_weights(tmp_path):
    rng = np.random.default_rng(5)
    alex, arrays = test_eval.TestLpipsParity._make_weights("alex", tmp_path, rng)
    _, vgg = test_eval.TestLpipsParity._make_weights("vgg", tmp_path, rng)
    both = tmp_path / "both.npz"
    np.savez(both, **{**arrays, **vgg})
    a, b = _pair(9, (64, 64, 3))
    got = tmet.VizScoreEvaluator(str(both), device="cpu").get_score(a, b)
    want = jmet.VizScoreEvaluator(str(both)).get_score(a, b)
    assert set(got) == set(want) >= {"lpipsa", "lpipsv"}
    for k in ("lpipsa", "lpipsv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_missing_lpips_weights_omit_the_keys():
    assert tlpips.lpips_fn("alex", "/nonexistent/weights.npz", "cpu") is None
    score = tmet.VizScoreEvaluator("/nonexistent/weights.npz",
                                   device="cpu").get_score(*_pair(1, (32, 32, 3)))
    assert set(score) == {"psnr", "ssim", "msssim", "dssim"}


# --------------------------------------------------------------------------
# pose metrics and pure helpers
# --------------------------------------------------------------------------


def _trajectory(seed, f=10, sim3=True):
    """GT c2w poses on an arc and a noisy (Sim(3)-transformed) estimate."""
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4), (f, 1, 1))
    est = np.tile(np.eye(4), (f, 1, 1))
    for i, ang in enumerate(np.linspace(-0.5, 0.5, f)):
        q = np.array([np.cos(ang / 2), 0.1, np.sin(ang / 2), 0.05])
        q /= np.linalg.norm(q)
        gt[i, :3, :3] = _quat_np(q)
        gt[i, :3, 3] = [np.sin(ang) * 3, np.cos(ang), ang * 2]
        qe = q + rng.normal(0, 0.01, 4)
        est[i, :3, :3] = _quat_np(qe / np.linalg.norm(qe))
        scale, shift = (1.7, [0.3, -0.2, 0.5]) if sim3 else (1.0, 0.0)
        est[i, :3, 3] = scale * gt[i, :3, 3] + shift + rng.normal(0, 0.02, 3)
    return gt, est


def _quat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.mark.parametrize("seed,sim3", [(0, True), (1, False), (2, True)])
def test_pose_metrics_match(seed, sim3):
    gt, est = _trajectory(seed, sim3=sim3)
    for a, b in zip(tpm.umeyama_sim3(gt[:, :3, 3], est[:, :3, 3]),
                    jpm.umeyama_sim3(gt[:, :3, 3], est[:, :3, 3])):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(tpm.compute_ate(gt, est),
                               jpm.compute_ate(gt, est), atol=1e-6)
    np.testing.assert_allclose(tpm.compute_rpe(gt, est),
                               jpm.compute_rpe(gt, est), atol=1e-6)
    got = tpm.PoseEvaluator().get_score(gt, est)
    want = jpm.PoseEvaluator().get_score(gt, est)
    for k in ("ATE", "RPE_trans", "RPE_rot"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)


def _nearest_case(query_x):
    db = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    db[:, :3, 3] = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0], [10, 0, 0]]
    q = np.eye(4, dtype=np.float32)
    q[:3, 3] = [query_x, 0.3, 0]
    return q, db


@pytest.mark.parametrize("fn,args", [
    ("search_nearest_two", [_nearest_case(x) for x in (2.2, -1.0, 9.0, 0.5)]),
    ("chunk_padded", [(list(range(n)), b) for n in (1, 2, 3, 5, 6, 7, 8, 9)
                      for b in (1, 2, 3, 8, 16)]),
    ("eval_fit_profile", [(240_000, 3_000_000, "huge"),
                          (240_000, 4_718_876, "huge"),
                          (240_000, 3_000_000, ("huge", 2)),
                          (240_000, 3_000_000, (3_686_400, 2)),
                          (100_000, 450_000, "lean"), (300, 700, "lean"),
                          (163_840, 403_991, "lean")]),
    ("escalated_profile", [(240_000, 5_000_000, ("huge", 2)),
                           (240_000, 2_000_000, "lean"),
                           (300, 2000, "lean")]),
])
def test_pure_helpers_match(fn, args):
    for a in args:
        if fn == "search_nearest_two":
            got, want = tpo.search_nearest_two(*a), jpo.search_nearest_two(*a)
            np.testing.assert_array_equal(got, want)
        elif fn == "chunk_padded":
            assert list(tev.chunk_padded(*a)) == list(jev.chunk_padded(*a))
        elif fn == "eval_fit_profile":
            assert tev.eval_fit_profile(*a) == jev.eval_fit_profile(*a), a
        else:
            # the JAX evaluator widens only; the port keeps a banded
            # capacity with fewer bands first, and widens unbanded ones the
            # same way (ROADMAP §3)
            from rodygs_tpu.render.compact import profile_for_demand
            got, widened = tev.escalated_profile(*a), profile_for_demand(*a)
            if isinstance(a[2], tuple):
                assert got == a[2][0] and widened is None
            else:
                assert widened is not None and got == widened


# --------------------------------------------------------------------------
# the evaluation scene: JAX trainers, their checkpoints, a datamodule
# --------------------------------------------------------------------------


def _arc_poses(angles, radius=3.0):
    q = np.array([[np.cos(a / 2), 0, np.sin(a / 2), 0] for a in angles],
                 np.float32)
    t = np.array([[np.sin(a) * radius, 0, 0] for a in angles], np.float32)
    return q, t


def _c2w(q, t):
    out = np.tile(np.eye(4, dtype=np.float32), (len(q), 1, 1))
    out[:, :3, :3] = [_quat_np(x) for x in q]
    out[:, :3, 3] = t
    return out


class _TestSet:
    """The duck-typed test dataset of both evaluators."""

    def __init__(self, frames, q, t):
        self.frames, self.q_c2w, self.t_c2w = frames, q, t
        self.image_height, self.image_width = frames[0]["image"].shape[:2]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]


class _DataModule:
    def __init__(self, test_set, train_poses, radius):
        self._test, self._train, self._radius = test_set, train_poses, radius
        self.skip_dynamic = False

    def get_test_dset(self):
        return self._test

    def get_test_sampler(self):
        return list(range(len(self._test)))

    def get_train_poses(self):
        return self._train

    def get_normalization(self):
        return {"radius": self._radius}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Seeded static and dynamic stores (SH 1, random motion), the JAX
    joint trainer's checkpoints of them, GT train poses on file, calibrated
    (noisy) train poses, and 3 test views between the train cameras whose
    GT is the port's render of a perturbed scene plus noise."""
    root = tmp_path_factory.mktemp("eval_scene")
    rng = np.random.default_rng(21)
    f32 = lambda x: np.asarray(x, np.float32)
    sm = f32(rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5], (N_STATIC, 3)))
    dm = f32(rng.uniform([-0.8, -0.5, 2.8], [0.8, 0.5, 3.8], (N_DYN, 3)))
    static = TG.from_point_cloud(sm, f32(rng.uniform(0.1, 0.9, (N_STATIC, 3))),
                                 sh_degree=1, capacity=CAP_S, device="cpu")
    dyn = TG.from_point_cloud(dm, f32(rng.uniform(0.1, 0.9, (N_DYN, 3))),
                              sh_degree=1, capacity=CAP_D,
                              times=f32(rng.choice([0.0, 0.5, 1.0], N_DYN)),
                              device="cpu")

    def livelier(store, n):
        p = store.params
        return store._replace(params=p._replace(
            opacity=torch.where(store.alive[:, None], 1.5, 0.0).float(),
            features_rest=torch.tensor(f32(rng.normal(0, 0.1, p.features_rest.shape))),
            scaling=p.scaling + 0.5))

    static, dyn = livelier(static, N_STATIC), livelier(dyn, N_DYN)
    angles = np.linspace(-0.15, 0.15, 4)
    gq, gt = _arc_poses(angles)
    cq = f32(gq + rng.normal(0, 0.003, gq.shape))
    cq /= np.linalg.norm(cq, axis=1, keepdims=True)
    ct = f32(gt + rng.normal(0, 0.01, gt.shape))

    s_kw = dict(image_width=W, image_height=H, sh_degree=1)
    d_kw = dict(s_kw, camera_rotation_lr=0.0, camera_translation_lr=0.0,
                deform_netwidth=32, deform_t_emb_multires=6, num_basis=4)
    loss = [{"name": "l1", "weight": 1.0, "target": "L1Loss"}]
    jst = jts.ThreeDGSTrainer(jts.StaticTrainerConfig(**s_kw),
                              jlosses.MultiLoss.from_config(loss),
                              _jax_store(static),
                              joptim.CameraPoses(jnp.asarray(cq),
                                                 jnp.asarray(ct)), 3.0)
    jdt = jtd.DynTrainer(jtd.DynTrainerConfig(**d_kw),
                         jlosses.MultiLoss.from_config(loss), _jax_store(dyn),
                         3.0, jax.random.key(7))
    coeff = jnp.asarray(rng.normal(0, 0.3, jdt.state.motion_coeff.shape)
                        * np.asarray(dyn.alive)[:, None, None], jnp.float32)
    net = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 0.3, x.shape),
                                             jnp.float32), jdt.state.net)
    jdt.state = jdt.state._replace(motion_coeff=coeff, net=net)
    jst.active_sh_degree = jdt.active_sh_degree = 1
    jax_dir = root / "jax_ckpt"
    jtj.RoDyGSTrainer(jst, jdt, logdir=jax_dir).save_checkpoints(600)

    data_dir = root / "data"
    data_dir.mkdir()
    gt_train = _c2w(gq, gt)
    with open(data_dir / "train_transforms.json", "w") as f:
        json.dump({"camera_angle_x": float(np.rad2deg(FOV)),
                   "frames": [{"transform_matrix": m.tolist()}
                              for m in gt_train]}, f)

    # test views halfway between the train cameras, GT from a perturbed scene
    tq, tt = _arc_poses((angles[:-1] + angles[1:]) / 2)
    p = TG.GaussianParams(*[torch.cat(x) for x in zip(static.params,
                                                      dyn.params)])
    p = p._replace(xyz=p.xyz + torch.tensor(f32(rng.normal(0, 0.01, p.xyz.shape))))
    frames = []
    for i in range(len(tq)):
        time = (2 * i + 1) / 6
        cam = tmake_camera(tq[i], tt[i], FOV, FOV * H / W, time, device="cpu")
        with torch.no_grad():
            img = trender(p.xyz, TG.get_features(p), TG.get_opacity(p),
                          TG.get_scaling(p), p.rotation, cam, 1, W, H,
                          alive=torch.cat([static.alive, dyn.alive]))[
                              "rendered_image"].numpy()
        frames.append({"image": f32(np.clip(img + rng.normal(0, 0.03, img.shape),
                                            0, 1)),
                       "image_name": f"view{i}", "time": time, "fovx": FOV,
                       "fovy": FOV * H / W})
    dm_obj = _DataModule(_TestSet(frames, tq, tt), _c2w(cq, ct), 3.0)
    return dict(root=root, jax_dir=jax_dir, data_dir=data_dir, dm=dm_obj,
                jst=jst, jdt=jdt, static=static, dyn=dyn, tq=tq, tt=tt,
                frames=frames)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _arrays_equal(a_tree, b_tree):
    fa, fb = _flat(a_tree), _flat(b_tree)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


@pytest.mark.parametrize("which", ["static_last.ckpt", "dynamic_last.ckpt"])
def test_jax_checkpoint_loads_in_the_port(scene, which):
    path = scene["jax_dir"] / which
    want, jit = jckpt.load_checkpoint(path)
    got, tit = tckpt.load_checkpoint(path)
    assert tit == jit == 600
    _arrays_equal(want, got)
    # the JAX package's NamedTuples arrive as the port's own
    assert type(got["optim"]["adam"]) is AdamState
    assert type(got["model"]["_xyz"]) is np.ndarray


def _port_joint(scene, logdir):
    """The port's joint trainer on the scene's JAX state."""
    jst, jdt = scene["jst"], scene["jdt"]
    loss = [{"name": "l1", "weight": 1.0, "target": "L1Loss"}]
    tst = tts.ThreeDGSTrainer(
        tts.StaticTrainerConfig(image_width=W, image_height=H, sh_degree=1),
        tlosses.MultiLoss.from_config(loss),
        convert.store_from_numpy(jst.state.store, "cpu"),
        convert.poses_from_numpy(jst.state.poses, "cpu"), 3.0, device="cpu")
    tdt = ttd.DynTrainer(
        ttd.DynTrainerConfig(image_width=W, image_height=H, sh_degree=1,
                             deform_netwidth=32, deform_t_emb_multires=6,
                             num_basis=4),
        tlosses.MultiLoss.from_config(loss),
        convert.store_from_numpy(jdt.state.store, "cpu"), 3.0, device="cpu")
    tdt.state = convert.dyn_state_from_numpy(jdt.state, "cpu")
    tst.active_sh_degree = tdt.active_sh_degree = 1
    return ttj.RoDyGSTrainer(tst, tdt, logdir=logdir)


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    joint = _port_joint(scene, tmp_path / "port_ckpt")
    joint.save_checkpoints(600)
    for name, trainer in (("static_last.ckpt", joint.static),
                          ("dynamic_last.ckpt", joint.dynamic)):
        got, it = jckpt.load_checkpoint(tmp_path / "port_ckpt" / name)
        assert it == 600
        _arrays_equal(trainer.state_dict(600), got)
        # the JAX package's own classes, resolved by the JAX unpickler
        assert type(got["optim"]["adam"]).__module__ == "rodygs_tpu.train.optim"
        back, _ = tckpt.load_checkpoint(tmp_path / "port_ckpt" / name)
        _arrays_equal(got, back)
    # the same state as the JAX trainer's own files
    for name in ("static_last.ckpt", "dynamic_last.ckpt"):
        _arrays_equal(jckpt.load_checkpoint(scene["jax_dir"] / name)[0],
                      jckpt.load_checkpoint(tmp_path / "port_ckpt" / name)[0])
    ev = jev.RoDyGSEvaluator(str(scene["data_dir"]), scene["dm"], scene["dm"],
                             tmp_path / "jax_eval",
                             tmp_path / "port_ckpt" / "static_last.ckpt",
                             tmp_path / "port_ckpt" / "dynamic_last.ckpt")
    assert ev.net_cfg.num_basis == 4


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def test_tampered_or_hostile_checkpoints_raise(scene, tmp_path):
    raw = (scene["jax_dir"] / "static_last.ckpt").read_bytes()
    bad = bytearray(raw)
    bad[-10] ^= 0xFF
    (tmp_path / "tampered.ckpt").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="integrity"):
        tckpt.load_checkpoint(tmp_path / "tampered.ckpt")
    # a well-formed v2 file whose payload reaches for os.system, and the
    # same as a legacy v1 raw pickle
    payload = pickle.dumps({"format": "rodygs_tpu.v2", "leaves": [_Evil()],
                            "treedef": 0, "iteration": 1})
    import hashlib
    digest = hashlib.sha256(payload).hexdigest().encode()
    (tmp_path / "evil.ckpt").write_bytes(tckpt._MAGIC + digest + b"\n"
                                         + payload)
    (tmp_path / "evil_v1.ckpt").write_bytes(payload)
    for name in ("evil.ckpt", "evil_v1.ckpt"):
        with pytest.raises(pickle.UnpicklingError, match="os.system|posix"):
            tckpt.load_checkpoint(tmp_path / name)


# --------------------------------------------------------------------------
# pose optimisation and the evaluator end to end
# --------------------------------------------------------------------------


def _static_render_fns(scene):
    """(JAX render_fn, port render_fn) of the static set, pose-gradient
    only, as the evaluators' pose optimisers render."""
    jsp = scene["jst"].state.store
    tsp = scene["static"]

    def jfn(cam):
        p = jsp.params
        return jrender(p.xyz, JG.get_features(p), JG.get_opacity(p),
                       JG.get_scaling(p), JG.get_rotation(p), cam, 1, W, H,
                       alive=jsp.alive, include_normal=False,
                       pose_grad_only=True)["rendered_image"]

    def tfn(cam):
        p = tsp.params
        return trender(p.xyz, TG.get_features(p), TG.get_opacity(p),
                       TG.get_scaling(p), TG.get_rotation(p), cam, 1, W, H,
                       alive=tsp.alive, include_normal=False,
                       pose_grad_only=True)["rendered_image"]
    return jfn, tfn


def test_pose_optimizer_matches(scene):
    jfn, tfn = _static_render_fns(scene)
    calib = scene["dm"].get_train_poses()
    gt_train = _c2w(*_arc_poses(np.linspace(-0.15, 0.15, 4)))
    q, t, frame = scene["tq"][1], scene["tt"][1], scene["frames"][1]
    gt_c2w = _c2w(q[None], t[None])[0]
    args = (camera_lr, num_opts) = (5e-3, 5)
    jopt = jpo.PoseOptimizer(calib, gt_train, jfn, *args)
    topt = tpo.PoseOptimizer(calib, gt_train, tfn, *args)
    jcam = jopt(jmake_camera(q, t, FOV, FOV * H / W, frame["time"]), gt_c2w,
                jnp.asarray(frame["image"]))
    tcam = topt(tmake_camera(q, t, FOV, FOV * H / W, frame["time"],
                             device="cpu"), gt_c2w, frame["image"])
    init = calib[tpo.search_nearest_two(gt_c2w, gt_train)[0]]
    assert np.abs(tcam.t_c2w.numpy() - init[:3, 3]).max() > 1e-3  # it moved
    np.testing.assert_allclose(tcam.q_c2w.numpy(), np.asarray(jcam.q_c2w),
                               atol=1e-6)
    np.testing.assert_allclose(tcam.t_c2w.numpy(), np.asarray(jcam.t_c2w),
                               atol=1e-6)


def _pngs(d):
    return {p: cv2.imread(os.path.join(d, p), cv2.IMREAD_UNCHANGED)
            for p in sorted(os.listdir(d))}


@pytest.mark.parametrize("align", [False, True])
def test_evaluator_matches(scene, tmp_path, align):
    kw = dict(camera_lr=5e-5, num_opts=3) if align else {}
    common = (str(scene["data_dir"]), scene["dm"], scene["dm"])
    ckpts = (scene["jax_dir"] / "static_last.ckpt",
             scene["jax_dir"] / "dynamic_last.ckpt")
    jevl = jev.RoDyGSEvaluator(*common, tmp_path / "jax", *ckpts, **kw)
    want = jevl.eval(eval_batch_size=2)
    tevl = tev.RoDyGSEvaluator(*common, tmp_path / "port", *ckpts,
                               device="cpu", **kw)
    got = tevl.eval(eval_batch_size=2)

    assert sorted(got) == sorted(want)
    assert sorted(got["timing"]) == sorted(want["timing"])
    assert "render_s_per_view_steady" in got["timing"]
    assert got["msssim_info"] == want["msssim_info"]
    assert set(got["viz"]) == set(want["viz"])
    for k in want["viz"]:
        np.testing.assert_allclose(got["viz"][k], want["viz"][k], atol=1e-4,
                                   err_msg=k)
    for k in want["pose"]:
        np.testing.assert_allclose(got["pose"][k], want["pose"][k], atol=1e-6,
                                   err_msg=k)
    assert got["pose"]["ATE"] > 0
    assert tevl.fragment_profile == jevl.fragment_profile

    for sub in ("gt", "pred"):
        jp = _pngs(tmp_path / "jax" / sub / "viz")
        tp = _pngs(tmp_path / "port" / sub / "viz")
        assert sorted(tp) == sorted(jp) and len(tp) == 3
        for name in jp:
            assert tp[name].dtype == np.uint16 and tp[name].shape == (H, W, 3)
            diff = np.abs(tp[name].astype(np.int64) - jp[name].astype(np.int64))
            assert diff.max() <= 2, (sub, name, diff.max())

    jy = yaml.safe_load((tmp_path / "jax" / "result.yaml").read_text())
    ty = yaml.safe_load((tmp_path / "port" / "result.yaml").read_text())
    assert ty == got

    def shape_of(d):
        return {k: (shape_of(v) if isinstance(v, dict) else type(v).__name__)
                for k, v in d.items()}
    assert shape_of(ty) == shape_of(jy)


def test_rgb_storer_matches_jax(tmp_path):
    img = _img(3, (7, 5, 3))
    img[0, 0] = [1.5, -0.2, 0.5]
    tstore.RGBStorer(tmp_path / "port", workers=0)("x.png", img)
    jstore.RGBStorer(tmp_path / "jax", workers=0)("x.png", img)
    back = cv2.imread(str(tmp_path / "port" / "x.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], tstore.to_u16(img))
    assert tuple(back[0, 0, ::-1]) == (65535, 0, 32767)
    np.testing.assert_array_equal(
        back, cv2.imread(str(tmp_path / "jax" / "x.png"),
                         cv2.IMREAD_UNCHANGED))


# --------------------------------------------------------------------------
# test-time pose alignment on static-only scenes: drops and isotropy
# --------------------------------------------------------------------------

SIZE = 128                    # 64 tiles of 16x16


def _static_only(tmp_path, big: int, isotropic: bool = False):
    """A static-only checkpoint of 128 slots: 128 - `big` small gaussians
    in front of the camera and `big` huge ones that each cover all 64
    tiles (a demand of about 128 + 63 * big fragments against lean's
    1,024 slots: 6 x 128 rounded up to whole 512-slot chunks), GT train
    poses on file, one test view and its datamodule."""
    rng = np.random.default_rng(4)
    f32 = lambda x: np.asarray(x, np.float32)
    n = 128
    pts = f32(rng.uniform([-0.8, -0.8, 3.0], [0.8, 0.8, 4.0], (n, 3)))
    store = TG.from_point_cloud(pts, f32(rng.uniform(0.1, 0.9, (n, 3))),
                                sh_degree=1, capacity=n, device="cpu",
                                isotropic=isotropic)
    scales = np.full((n, 1 if isotropic else 3), np.log(0.01), np.float32)
    scales[:big] = np.log(3.0)
    store = store._replace(params=store.params._replace(
        scaling=torch.tensor(scales),
        opacity=torch.full((n, 1), 0.5)))
    gq, gt = _arc_poses(np.linspace(-0.05, 0.05, 3))
    loss = [{"name": "l1", "weight": 1.0, "target": "L1Loss"}]
    trainer = tts.ThreeDGSTrainer(
        tts.StaticTrainerConfig(image_width=SIZE, image_height=SIZE,
                                sh_degree=1, isotropic=isotropic),
        tlosses.MultiLoss.from_config(loss), store,
        tlosses_poses(gq, gt), 3.0, device="cpu")
    tckpt.save_checkpoint(tmp_path / "static_last.ckpt",
                          trainer.state_dict(100), 100)
    with open(tmp_path / "train_transforms.json", "w") as f:
        json.dump({"camera_angle_x": float(np.rad2deg(FOV)),
                   "frames": [{"transform_matrix": m.tolist()}
                              for m in _c2w(gq, gt)]}, f)
    tq, tt = _arc_poses([0.02])
    cam = tmake_camera(tq[0], tt[0], FOV, FOV, 0.5, device="cpu")
    with torch.no_grad():
        p = store.params
        img = trender(p.xyz, TG.get_features(p), TG.get_opacity(p),
                      TG.get_scaling(p, isotropic), p.rotation, cam, 1, SIZE,
                      SIZE, fragment_profile="huge")["rendered_image"].numpy()
    frames = [{"image": img, "image_name": "view0", "time": 0.5,
               "fovx": FOV, "fovy": FOV}]
    dm = _DataModule(_TestSet(frames, tq, tt), _c2w(gq, gt), 3.0)
    dm.skip_dynamic = True
    return dm, cam


def tlosses_poses(q, t):
    from rodygs_tpu_torch.train.optim import CameraPoses

    return CameraPoses(torch.tensor(q), torch.tensor(t))


def _aligned_evaluator(tmp_path, dm):
    return tev.RoDyGSEvaluator(str(tmp_path), dm, None, tmp_path / "out",
                               tmp_path / "static_last.ckpt", None,
                               camera_lr=5e-5, num_opts=2, device="cpu")


def test_pose_steps_never_render_clipped(tmp_path, monkeypatch):
    """A few huge static gaussians push the pose render's demand past
    lean's capacity: every pose step (a render with gradients) must drop
    nothing. The probe before the steps renders without gradients."""
    dm, _ = _static_only(tmp_path, big=20)
    seen = []

    def recording(*args, **kwargs):
        out = trender(*args, **kwargs)
        if kwargs.get("pose_grad_only") and torch.is_grad_enabled():
            seen.append((int(out["num_fragments"]), int(out["dropped"])))
        return out

    monkeypatch.setattr(tev, "render", recording)
    ev = _aligned_evaluator(tmp_path, dm)
    result = ev.eval(eval_batch_size=1)
    assert len(seen) == 2
    lean = fragment_capacity(TG.capacity_of(ev.static_store), "lean")
    assert all(demand > lean for demand, _ in seen), seen
    assert [d for _, d in seen] == [0, 0], seen
    assert ev.pose_render_stats == {"steps": 2, "retried": 0, "dropped": 0}
    assert np.isfinite(result["viz"]["psnr"])


def test_a_dropping_pose_step_is_taken_again(tmp_path):
    """A step whose render drops fragments escalates the profile and renders
    again: its image is the unclipped one."""
    dm, cam = _static_only(tmp_path, big=20)
    ev = _aligned_evaluator(tmp_path, dm)
    ev.pose_fragment_profile = "lean"
    cam = cam._replace(q_c2w=cam.q_c2w.clone().requires_grad_(True))
    img = ev._render_rgb_for_poseopt(cam)
    assert ev.pose_fragment_profile != "lean"
    assert ev.pose_render_stats == {"steps": 1, "retried": 1, "dropped": 0}
    full = ev._render_static(cam, "huge")
    assert int(full["dropped"]) == 0
    np.testing.assert_array_equal(img.detach().numpy(),
                                  full["rendered_image"].detach().numpy())
    img.sum().backward()
    assert torch.isfinite(cam.q_c2w.grad).all()


def test_alignment_on_an_isotropic_checkpoint(tmp_path):
    """An isotropic static model ([C, 1] log-scales) through test-time pose
    alignment: the pose render expands the scales as the view render
    does."""
    dm, cam = _static_only(tmp_path, big=0, isotropic=True)
    ev = _aligned_evaluator(tmp_path, dm)
    assert ev.static_isotropic
    result = ev.eval(eval_batch_size=1)
    assert np.isfinite(result["viz"]["psnr"]) and result["viz"]["psnr"] > 20
    with torch.no_grad():
        got = ev._render_rgb_for_poseopt(cam)
    np.testing.assert_allclose(got.numpy(), dm.get_test_dset()[0]["image"],
                               atol=2e-5)


@pytest.mark.parametrize("by", ["position", "name"])
def test_evaluator_takes_the_model_arguments(tmp_path, by):
    """The JAX evaluator accepts `static_model` and `dynamic_model` after
    `num_opts` and ignores them; the port's constructor takes them at the
    same positions, by position and by name, and builds the same evaluator
    as without them."""
    dm, _ = _static_only(tmp_path, big=0)
    head = (str(tmp_path), dm, None, tmp_path / "out",
            tmp_path / "static_last.ckpt", None, 5e-5, 2)
    models = (object(), object())
    if by == "position":
        ev = tev.RoDyGSEvaluator(*head, *models, None, device="cpu")
    else:
        ev = tev.RoDyGSEvaluator(*head, static_model=models[0],
                                 dynamic_model=models[1], lpips_weights=None,
                                 device="cpu")
    plain = _aligned_evaluator(tmp_path, dm)
    assert ev.device == plain.device == torch.device("cpu")
    assert ev.is_optimizable_cam and ev.skip_dynamic
    assert ev.pose_optimizer.num_opts == plain.pose_optimizer.num_opts == 2
    for a, b in zip(ev.static_store.params, plain.static_store.params):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
