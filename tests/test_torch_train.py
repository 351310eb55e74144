"""Parity of the PyTorch port's training pieces with the JAX package on the
CPU: Adam, densify statistics, the L1 + D-SSIM MultiLoss, the capacity
poller, point-cloud init, state conversion, and one static train step from
identical converted state.

Adam with eps 1e-15 turns the sign of a near-zero gradient into a full
+-lr step, so the step test compares the gradients before Adam, runs
`adam_update` alone on identical gradients, and compares post-step
parameters only where |g| > 1e-3 max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.render.camera import make_camera as jmake_camera
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu.train import densify as jdens
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_static as jts
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.models import motion as tmotion
from rodygs_tpu_torch.render import camera as tcamera
from rodygs_tpu_torch.train import densify as tdens
from rodygs_tpu_torch.train import losses as tlosses
from rodygs_tpu_torch.train import optim as toptim
from rodygs_tpu_torch.train import trainer_dynamic as ttd
from rodygs_tpu_torch.train import trainer_joint as ttj
from rodygs_tpu_torch.train import trainer_static as tts
from rodygs_tpu_torch.utils.platform import resolve_device

W, H = 64, 48
GRAD_TOL = 5e-4


def T(x):
    return torch.tensor(np.array(x))


def assert_scaled(a, b, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-8
    np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL, err_msg=name)


def _params(seed, cap=32):
    rng = np.random.default_rng(seed)
    shapes = dict(xyz=(cap, 3), features_dc=(cap, 1, 3),
                  features_rest=(cap, 15, 3), scaling=(cap, 3),
                  rotation=(cap, 4), opacity=(cap, 1))
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("gate", [None, 0.0, 1.0])
def test_adam_update_matches(gate):
    p, g1, g2 = _params(0), _params(1), _params(2)
    jp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in p.items()})
    tp = TG.GaussianParams(**{k: T(v) for k, v in p.items()})
    lr = JG.GaussianParams(*[1e-3 * (i + 1) for i in range(6)])
    tlr = TG.GaussianParams(*lr)
    js, ts = joptim.adam_init(jp), toptim.adam_init(tp)
    for g in (g1, g2):
        jp, js = joptim.adam_update(
            JG.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
            js, jp, lr, update_gate=gate)
        tp, ts = toptim.adam_update(
            TG.GaussianParams(**{k: T(v) for k, v in g.items()}),
            ts, tp, tlr, update_gate=gate)
    for name in JG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(getattr(ts.nu, name).numpy(),
                                   np.asarray(getattr(js.nu, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert int(ts.count) == int(js.count)


def test_camera_lr_tree_matches():
    for step in (1.0, 10.0, 5000.0):
        j = joptim.camera_lr_tree(step, 1e-5, 1e-6, 100, 20000)
        t = toptim.camera_lr_tree(step, 1e-5, 1e-6, 100, 20000)
        for a, b in zip(j, t):
            np.testing.assert_allclose(b.item(), float(a), rtol=1e-6)


def test_accumulate_stats_matches():
    rng = np.random.default_rng(3)
    cap = 50
    g = rng.normal(size=(2, cap)).astype(np.float32)
    radii = rng.integers(0, 9, cap).astype(np.float32)
    vis = radii > 2
    js = jdens.accumulate_stats(jdens.init_stats(cap), jnp.asarray(g),
                                jnp.asarray(radii), jnp.asarray(vis))
    ts = tdens.accumulate_stats(tdens.init_stats(cap, device="cpu"), T(g),
                                T(radii), T(vis))
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_multiloss_matches():
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    terms = [("l1", 0.8, "L1Loss", 1, 0), ("d_ssim", 0.2, "SSIMLoss", 2, 3)]
    jl = jlosses.MultiLoss([jlosses.LossTerm(*t) for t in terms])
    tl = tlosses.MultiLoss([tlosses.LossTerm(*t) for t in terms])
    for it in (1, 4, 5):
        assert jl.active_set(it) == tl.active_set(it)
        jt, jd = jl({"pred_img": jnp.asarray(pred), "gt_img": jnp.asarray(gt)},
                    jl.active_set(it))
        tt, td = tl({"pred_img": T(pred), "gt_img": T(gt)}, tl.active_set(it))
        np.testing.assert_allclose(tt.item(), float(jt), rtol=1e-6)
        assert sorted(jd) == sorted(td)
    assert tl.uses_normal == jl.uses_normal
    with pytest.raises(NotImplementedError):
        tlosses.MultiLoss([tlosses.LossTerm("n", 1.0, "NormalConsistencyLoss")])


def test_escalation_poller_matches():
    rng = np.random.default_rng(5)
    jp, tp = jts.EscalationPoller(), tts.EscalationPoller()
    jprof = tprof = "lean"
    cap = 131072
    for it in range(1, 400):
        demand = int(rng.choice([300_000, 500_000, 900_000, 2_000_000]))
        metrics = {"num_fragments": demand,
                   "overflow": demand > jts.fragment_capacity(cap, jprof)}
        jw = jp.poll(it, metrics, cap, jprof)
        tw = tp.poll(it, metrics, cap, tprof)
        assert jw == tw, it
        if jw is not None:
            jprof = tprof = jw


def test_from_point_cloud_matches():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (150, 3)).astype(np.float32)
    times = rng.choice([0.0, 0.5, 1.0], 150).astype(np.float32)
    js = JG.from_point_cloud(pts, cols, 3, capacity=256, times=times)
    ts = TG.from_point_cloud(pts, cols, 3, capacity=256, times=times,
                             device="cpu")
    for name in JG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(ts.params, name).numpy(),
                                   np.asarray(getattr(js.params, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    assert TG.capacity_of(ts) == JG.capacity_of(js) == 256
    assert TG.sh_degree_up(2, 3) == JG.sh_degree_up(2, 3) == 3


@pytest.mark.parametrize("isotropic", [False, True])
def test_active_arrays_match(isotropic):
    rng = np.random.default_rng(8)
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (40, 3)).astype(np.float32)
    js = JG.from_point_cloud(pts, cols, 2, capacity=64, isotropic=isotropic)
    ts = TG.from_point_cloud(pts, cols, 2, capacity=64, isotropic=isotropic,
                             device="cpu")
    for a, b in zip(JG.active_arrays(js, isotropic),
                    TG.active_arrays(ts, isotropic)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_convert_round_trip():
    js = JG.from_point_cloud(np.random.default_rng(7).uniform(
        -1, 1, (40, 3)).astype(np.float32), np.full((40, 3), 0.5, np.float32),
        1, capacity=64)
    opt = joptim.adam_init(js.params)
    ts = convert.store_from_numpy(js, device="cpu")
    back = convert.store_to_numpy(ts)
    for name in JG.GaussianParams._fields:
        np.testing.assert_array_equal(back["params"][name],
                                      np.asarray(getattr(js.params, name)))
    np.testing.assert_array_equal(back["alive"], np.asarray(js.alive))
    topt = convert.adam_from_numpy(opt, TG.GaussianParams, device="cpu")
    assert convert.adam_to_numpy(topt)["count"] == 0
    poses = joptim.CameraPoses(jnp.ones((2, 4)), jnp.zeros((2, 3)))
    np.testing.assert_array_equal(
        convert.poses_to_numpy(convert.poses_from_numpy(poses, "cpu"))["q_c2w"],
        np.ones((2, 4), np.float32))
    stats = jdens.init_stats(64)
    assert convert.stats_to_numpy(
        convert.stats_from_numpy(stats, "cpu"))["denom"].shape == (64,)


def test_resolve_device_refuses_missing_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)


def _small_dyn_trainer(dev):
    store = TG.from_point_cloud(np.random.default_rng(0).uniform(
        -1, 1, (8, 3)).astype(np.float32), np.full((8, 3), 0.5, np.float32),
        1, capacity=16, device="cpu")
    cfg = ttd.DynTrainerConfig(sh_degree=1, deform_netwidth=8,
                               deform_t_emb_multires=2, num_basis=2)
    return ttd.DynTrainer(cfg, tlosses.MultiLoss([]), store, 1.0, device=dev)


def _small_joint_trainer(dev):
    store = TG.from_point_cloud(np.zeros((1, 3), np.float32),
                                np.full((1, 3), 0.5, np.float32), 1,
                                capacity=4, device="cpu")
    poses = toptim.CameraPoses(torch.ones((1, 4)), torch.zeros((1, 3)))
    static = tts.ThreeDGSTrainer(tts.StaticTrainerConfig(sh_degree=1),
                                 tlosses.MultiLoss([]), store, poses, 1.0,
                                 device=dev)
    joint = ttj.RoDyGSTrainer(static, _small_dyn_trainer(dev))
    return (toptim.tree_leaves(joint.static.state)
            + toptim.tree_leaves(joint.dynamic.state))


@pytest.mark.parametrize("make", [
    lambda dev: tcamera.make_camera([1.0, 0, 0, 0], [0.0, 0, 0], 0.9, 0.9,
                                    device=dev),
    lambda dev: tcamera.camera_from_w2c(np.eye(3), np.zeros(3), 0.9, 0.9,
                                        device=dev),
    lambda dev: tdens.init_stats(8, device=dev),
    lambda dev: toptim.tree_leaves(tmotion.init_motion_params(
        0, tmotion.MotionNetConfig(netwidth=8, num_basis=2, t_emb_multires=2),
        device=dev)),
    lambda dev: toptim.tree_leaves(_small_dyn_trainer(dev).state),
    _small_joint_trainer,
])
def test_constructors_default_to_cuda(make):
    assert all(x.device == torch.device("cpu") for x in make("cpu"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(None)


# --------------------------------------------------------------------------
# one static train step from identical converted state
# --------------------------------------------------------------------------


def _bench_like_setup(n=200, cap=256, n_frames=2):
    """bench.py's scene recipe at a small size."""
    rng = np.random.default_rng(7)
    pts = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0],
                      size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    store = JG.from_point_cloud(pts, cols, sh_degree=3, capacity=cap)
    scales = np.exp(rng.uniform(-3.2, -1.8, size=(cap, 3))).astype(np.float32)
    sh_rest = rng.normal(0, 0.05, size=(cap, 15, 3)).astype(np.float32)
    store = store._replace(params=store.params._replace(
        scaling=jnp.asarray(np.log(scales)),
        features_rest=jnp.asarray(sh_rest)))
    qs, ts = [], []
    for ang in np.linspace(-0.1, 0.1, n_frames):
        qs.append([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        ts.append([np.sin(ang) * 1.0, 0, 0])
    poses = joptim.CameraPoses(q_c2w=jnp.asarray(qs, jnp.float32),
                               t_c2w=jnp.asarray(ts, jnp.float32))
    p = store.params
    cam = jmake_camera(poses.q_c2w[0], poses.t_c2w[0], 0.9, 0.7, 0.0)
    img = np.asarray(jrender(p.xyz, JG.get_features(p), JG.get_opacity(p),
                             JG.get_scaling(p), p.rotation, cam, 3, W, H,
                             alive=store.alive)["rendered_image"])
    gt = np.clip(img + np.random.default_rng(11).normal(0, 0.05, img.shape),
                 0, 1).astype(np.float32)
    return store, poses, gt


def test_static_train_step_matches():
    store, poses, gt = _bench_like_setup()
    kw = dict(image_width=W, image_height=H, sh_degree=3,
              densification_interval=0, densify_from_iter=10**9,
              camera_rotation_lr=1e-5, camera_translation_lr=1e-6)
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
    jtr.active_sh_degree = ttr.active_sh_degree = 2
    jbatch = jts.FrameBatch(gt_image=jnp.asarray(gt), gt_depth=None,
                            motion_mask=None, frame_idx=jnp.asarray(0),
                            time=jnp.asarray(0.0), fovx=jnp.asarray(0.9),
                            fovy=jnp.asarray(0.7))
    tbatch = tts.FrameBatch(gt_image=T(gt), gt_depth=None, motion_mask=None,
                            frame_idx=0, time=torch.tensor(0.0),
                            fovx=torch.tensor(0.9), fovy=torch.tensor(0.7))
    active = jtr.loss.active_set(1)
    jstate = jtr.state

    # gradients before Adam
    def jloss(params, poses_, offset):
        out, _ = jtr._render_ctx(params, jstate.store.alive, poses_, offset,
                                 jbatch, 2)
        ctx = {"pred_img": out["rendered_image"], "gt_img": jbatch.gt_image}
        return jtr.loss(ctx, active)[0]

    off0 = jnp.zeros((2, JG.capacity_of(store)), jnp.float32)
    jtotal, (jgp, jgpose, jgoff) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2))(jstate.store.params, jstate.poses, off0)
    ttotal, _, (tgp, tgpose, tgoff) = ttr.loss_and_grads(
        ttr.state, tbatch, active, 2)
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=1e-5)
    for name in JG.GaussianParams._fields:
        assert_scaled(getattr(jgp, name), getattr(tgp, name).numpy(), name)
    assert_scaled(jgpose.q_c2w, tgpose.q_c2w.numpy(), "q_c2w")
    assert_scaled(jgpose.t_c2w, tgpose.t_c2w.numpy(), "t_c2w")
    # the JAX package's offset gradient is dL/dpixel / (0.5*[W, H]); the
    # port's is the reference's dL/dpixel * 0.5*[W, H]
    ndc2 = np.array([[(0.5 * W) ** 2], [(0.5 * H) ** 2]], np.float32)
    jgoff = np.asarray(jgoff) * ndc2
    assert_scaled(jgoff, tgoff.numpy(), "means2d_offset")
    assert np.abs(tgpose.q_c2w.numpy()).max() > 0

    # Adam alone on identical gradients
    lr = jts._param_lr_tree(jtr.cfg, jnp.asarray(1.0), 4.0)
    jnew, _ = joptim.adam_update(jgp, jstate.opt, jstate.store.params, lr)
    tnew, _ = toptim.adam_update(
        TG.GaussianParams(*[T(x) for x in jgp]), ttr.state.opt,
        ttr.state.store.params, tts._param_lr_tree(ttr.cfg, 1.0, 4.0))
    for name in JG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tnew, name).numpy(),
                                   np.asarray(getattr(jnew, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)

    # the full iteration: post-step state where the gradient is not tiny
    jm = jtr.train_iteration(jbatch, 1, jax.random.key(0))
    tm = ttr.train_iteration(tbatch, 1)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert int(tm["num_fragments"]) == int(jm["num_fragments"])
    js, tsn = jtr.state, ttr.state
    for name in JG.GaussianParams._fields:
        g = np.asarray(getattr(jgp, name))
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        assert mask.any()
        np.testing.assert_allclose(
            getattr(tsn.store.params, name).numpy()[mask],
            np.asarray(getattr(js.store.params, name))[mask],
            rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("q_c2w", "t_c2w"):
        g = np.asarray(getattr(jgpose, name))
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(getattr(tsn.poses, name).numpy()[mask],
                                   np.asarray(getattr(js.poses, name))[mask],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert_scaled(np.sqrt((jgoff ** 2).sum(0)) * np.asarray(js.stats.denom),
                  tsn.stats.grad_accum.numpy())
    np.testing.assert_array_equal(tsn.stats.denom.numpy(),
                                  np.asarray(js.stats.denom))
    np.testing.assert_array_equal(tsn.stats.max_radii2d.numpy(),
                                  np.asarray(js.stats.max_radii2d))
    assert int(tsn.opt.count) == int(js.opt.count) == 1
