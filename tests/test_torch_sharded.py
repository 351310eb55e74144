"""Parity of the port's sharded train steps and densification with the JAX
package's (`rodygs_tpu/parallel/sharded.py`) on the CPU: the static step
on 2 x 1 x 2 and 1 x 2 x 2 meshes, the dynamic step on 2 x 1 x 2 and
1 x 2 x 1, and both densifications on 1 x 2 x 1, each from identical
state.

The JAX side runs its jitted `shard_map` steps on k of the 8 virtual CPU
devices here; the port's side runs in a spawned Gloo world of k ranks
(tests/torch_parallel_ranks.py). The Adam moments are seeded (a first step
from zero moments is lr * sign(g), noise for near-zero gradients), the JAX
renders take the densification offset in the reference's units (ROADMAP
fault 2), and the split samples are the same numpy draws on both sides: the
JAX draws recorded in call order (one `shard_map` body, so every shard
draws the same), replayed to every rank. Bars: parameters after one step
5e-5 (tests/test_parallel.py), moments, gradients and the screen-gradient
statistic by their max 5e-4, counts and radii exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.parallel import mesh as jmesh
from rodygs_tpu.parallel import sharded as jsharded
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu.train import densify as jdens
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_dynamic as jtd
from rodygs_tpu.train import trainer_static as jts
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.parallel.dryrun import run_world
from rodygs_tpu_torch.train import losses as tlosses
from rodygs_tpu_torch.train import trainer_static as tts

import torch_parallel_ranks as ranks
from test_torch_densify import _state as densify_state
from test_torch_dynamic import _joint_scene, _seeded_adam, _seeded_stats

PARAM_TOL, GRAD_TOL = 5e-5, 5e-4
WORLD_TIMEOUT = 240.0
STATIC_LOSS = [("l1", 0.8, "L1Loss"), ("d_ssim", 0.2, "SSIMLoss")]
DYN_LOSS = [("l1", 0.8, "L1Loss"), ("motion_l1", 0.01, "MotionL1Loss")]
ITERATION = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this process (the ranks run on one each):
    the suite runs several worker processes on the same cores, where
    torch's OpenMP barriers wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    """Pure numpy (dicts of arrays) of JAX NamedTuples / dicts / arrays."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return np.array(tree)


def flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_scaled(a, b, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-10
    np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL,
                               err_msg=name)


def cmp(jtree, ttree, check, what):
    jf, tf = flat(jtree, what), flat(ttree, what)
    assert sorted(jf) == sorted(tf), (sorted(jf), sorted(tf))
    for k in jf:
        check(jf[k], tf[k], k)


def close(a, b, name):
    np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_TOL, err_msg=name)


def jax_mesh(shape):
    k = shape["data"] * shape["gauss"] * shape["tile"]
    return jmesh.make_mesh(n_data=shape["data"], n_tile=shape["tile"],
                           n_gauss=shape["gauss"], devices=jax.devices()[:k])


@pytest.fixture
def reference_units(monkeypatch):
    """The JAX sharded steps' render takes its densification offset times
    (0.5 * [W, H])^2, so both sides' statistics are in the reference's
    units (ROADMAP fault 2)."""
    def render(*args, means2d_offset=None, **kwargs):
        w, h = args[7], args[8]
        ndc2 = jnp.asarray([[(0.5 * w) ** 2], [(0.5 * h) ** 2]], jnp.float32)
        return jrender(*args, means2d_offset=means2d_offset * ndc2, **kwargs)

    monkeypatch.setattr(jsharded, "render", render)


def frame_batches(views):
    """[(numpy frame for the ranks, JAX FrameBatch)] of (gt, depth, idx,
    time) views."""
    out = []
    for gt, depth, idx, t in views:
        np_frame = dict(gt_image=gt, gt_depth=depth, frame_idx=idx, time=t,
                        fovx=0.9, fovy=0.7)
        out.append((np_frame, jts.FrameBatch(
            gt_image=jnp.asarray(gt),
            gt_depth=None if depth is None else jnp.asarray(depth),
            motion_mask=None, frame_idx=jnp.asarray(idx, jnp.int32),
            time=jnp.asarray(t, jnp.float32), fovx=jnp.asarray(0.9),
            fovy=jnp.asarray(0.7))))
    return out


@pytest.fixture(scope="module")
def joint_scene():
    return _joint_scene()


def views_for(n, img, depth, t):
    rng = np.random.default_rng(31)
    noisy = np.clip(img[::-1] + rng.normal(0, 0.05, img.shape), 0, 1)
    return [(img, None, 1, t), (noisy.astype(np.float32), None, 2, 0.5)][:n]


# --------------------------------------------------------------------------
# static step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    {"data": 2, "gauss": 1, "tile": 2},
    {"data": 1, "gauss": 2, "tile": 2},
], ids=["2x1x2", "1x2x2"])
def test_static_step_matches_jax(reference_units, joint_scene, shape):
    static, _, poses, img, depth, t = joint_scene
    W, H = img.shape[1], img.shape[0]
    kw = dict(image_width=W, image_height=H, sh_degree=1,
              camera_rotation_lr=1e-4, camera_translation_lr=1e-4)
    rng = np.random.default_rng(4)
    state = jts.init_static_state(static, poses)._replace(
        opt=_seeded_adam(rng, static.params),
        cam_opt=_seeded_adam(rng, poses, scale=0.01),
        stats=_seeded_stats(rng, np.asarray(static.alive), 0.3))
    batches = frame_batches(views_for(shape["data"], img, depth, t))
    jloss = jlosses.MultiLoss([jlosses.LossTerm(*x) for x in STATIC_LOSS])
    jstep = jsharded.make_sharded_static_step(
        jts.StaticTrainerConfig(**kw), jloss, jax_mesh(shape), 3.0)
    jnew, jm = jstep(state, jsharded.stack_batches([b for _, b in batches]),
                     jax.random.key(0), jnp.asarray(float(ITERATION)),
                     active=jloss.active_set(ITERATION), sh_degree=1)

    out = run_world(ranks.static_step, 4, (shape, dict(
        cfg=kw, loss=STATIC_LOSS, state=to_np(state), iteration=ITERATION,
        sh_degree=1, batch=[f for f, _ in batches])), backend="gloo",
        timeout_s=WORLD_TIMEOUT)
    r0 = out[0]
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jm["loss"]), rtol=1e-5)
        assert r["frag"] == [int(jm["overflow"]), int(jm["dropped"]),
                             int(jm["num_fragments"])]
    got = r0["state"]
    cmp(jnew.store.params, got["store"]["params"], close, "params")
    for name in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(got["store"][name],
                                      np.asarray(getattr(jnew.store, name)))
    cmp(jnew.poses, got["poses"], close, "poses")
    for opt in ("opt", "cam_opt"):
        for moment in ("mu", "nu"):
            cmp(getattr(getattr(jnew, opt), moment), got[opt][moment],
                assert_scaled, f"{opt}.{moment}")
        assert int(got[opt]["count"]) == int(getattr(jnew, opt).count)
    assert_scaled(jnew.stats.grad_accum, got["stats"]["grad_accum"])
    np.testing.assert_array_equal(got["stats"]["denom"],
                                  np.asarray(jnew.stats.denom))
    np.testing.assert_array_equal(got["stats"]["max_radii2d"],
                                  np.asarray(jnew.stats.max_radii2d))
    assert (np.asarray(jnew.stats.denom) != np.asarray(state.stats.denom)).any()

    # the gradients themselves: the mean over the frames of the port's
    # single-process gradients
    tr = tts.ThreeDGSTrainer(
        tts.StaticTrainerConfig(**kw),
        tlosses.MultiLoss([tlosses.LossTerm(*x) for x in STATIC_LOSS]),
        convert.store_from_numpy(static, "cpu"),
        convert.poses_from_numpy(poses, "cpu"), 3.0, device="cpu")
    single = []
    for f, _ in batches:
        frame = ranks.frames([f])
        frame = ranks.S.batch_row(frame, 0)
        single.append(tr.loss_and_grads(tr.state, frame,
                                        tr.loss.active_set(ITERATION), 1)[2])
    for i, name in enumerate(("g_params", "g_poses")):
        mean = {k: np.mean([s[i]._asdict()[k].numpy() for s in single], 0)
                for k in single[0][i]._fields}
        cmp(mean, r0[name], assert_scaled, name)


# --------------------------------------------------------------------------
# dynamic step
# --------------------------------------------------------------------------


def _dyn_setup(joint_scene, seed):
    static, dyn, poses, img, depth, t = joint_scene
    W, H = img.shape[1], img.shape[0]
    kw = dict(image_width=W, image_height=H, sh_degree=1, deform_netwidth=32,
              deform_t_emb_multires=6, num_basis=4)
    jloss = jlosses.MultiLoss([jlosses.LossTerm(*x) for x in DYN_LOSS])
    jdt = jtd.DynTrainer(jtd.DynTrainerConfig(**kw), jloss, dyn, 3.0,
                         jax.random.key(seed))
    rng = np.random.default_rng(seed)
    coeff = jnp.asarray(rng.normal(0, 0.3, jdt.state.motion_coeff.shape)
                        * np.asarray(dyn.alive)[:, None, None], jnp.float32)
    jdt.state = jdt.state._replace(
        motion_coeff=coeff,
        opt=_seeded_adam(rng, jtd.DynParams(dyn.params, coeff, jdt.state.net)),
        stats=_seeded_stats(rng, np.asarray(dyn.alive), 0.4))
    setup = dict(cfg=kw, loss=DYN_LOSS, dyn=to_np(jdt.state),
                 unique_times=np.asarray(jdt.unique_times))
    return jdt, jloss, setup


@pytest.mark.parametrize("shape", [
    {"data": 2, "gauss": 1, "tile": 2},
    {"data": 1, "gauss": 2, "tile": 1},
], ids=["2x1x2", "1x2x1"])
def test_dynamic_step_matches_jax(reference_units, joint_scene, shape):
    static, _, poses, img, depth, t = joint_scene
    jdt, jloss, setup = _dyn_setup(joint_scene, 8)
    batches = frame_batches(views_for(shape["data"], img, depth, t))
    jstep = jsharded.make_sharded_dynamic_step(jdt, jdt.cfg, jloss,
                                               jax_mesh(shape))
    jnew, jm = jstep(jdt.state, static, poses,
                     jsharded.stack_batches([b for _, b in batches]),
                     jax.random.key(1), jnp.asarray(float(ITERATION)),
                     active=jloss.active_set(ITERATION), sh_degree=1,
                     use_deform=True)
    k = shape["data"] * shape["gauss"] * shape["tile"]
    out = run_world(ranks.dynamic_step, k, (shape, dict(
        setup, static_store=to_np(static), poses=to_np(poses),
        iteration=ITERATION, sh_degree=1, batch=[f for f, _ in batches])),
        backend="gloo", timeout_s=WORLD_TIMEOUT)
    for r in out:
        np.testing.assert_allclose(r["loss"], float(jm["loss"]), rtol=1e-5)
        assert r["frag"] == [int(jm["overflow"]), int(jm["dropped"]),
                             int(jm["num_fragments"])]
    got = out[0]["state"]
    cmp(jnew.store.params, got["store"]["params"], close, "params")
    cmp(jnew.motion_coeff, got["motion_coeff"], close, "motion_coeff")
    cmp(jnew.net, got["net"], close, "net")
    for moment in ("mu", "nu"):
        cmp(getattr(jnew.opt, moment), got["opt"][moment], assert_scaled,
            moment)
    assert int(got["opt"]["count"]) == int(jnew.opt.count)
    assert_scaled(jnew.stats.grad_accum, got["stats"]["grad_accum"])
    np.testing.assert_array_equal(got["stats"]["denom"],
                                  np.asarray(jnew.stats.denom))
    np.testing.assert_array_equal(got["stats"]["max_radii2d"],
                                  np.asarray(jnew.stats.max_radii2d))
    moved = np.abs(got["motion_coeff"] - setup["dyn"]["motion_coeff"]).max()
    assert moved > 0


# --------------------------------------------------------------------------
# densification
# --------------------------------------------------------------------------


class Draws:
    """jax.random.normal recorded in call order from one numpy generator."""

    def __init__(self, monkeypatch, seed):
        self.rng = np.random.default_rng(seed)
        self.log = []
        monkeypatch.setattr(jax.random, "normal", self.normal)

    def normal(self, key, shape, dtype=jnp.float32):
        self.log.append(self.rng.standard_normal(shape).astype(np.float32))
        return jnp.asarray(self.log[-1])

    def take(self):
        out, self.log = self.log, []
        return out


def _interleave(tree, n):
    """`shard_interleave`'s slot permutation on every leaf of a tree."""
    def perm(x):
        c = x.shape[0]
        return x[np.arange(c).reshape(c // n, n).T.reshape(-1)]

    if isinstance(tree, dict):
        return {k: _interleave(v, n) for k, v in tree.items()}
    return perm(np.asarray(tree))


def test_sharded_densify_both_stores_match_jax(monkeypatch, joint_scene):
    """1 x 2 x 1: each gauss shard densifies its capacity block (static) or
    its slice of the replicated dynamic store, clones / splits / prunes
    moving the moments and motion coefficients; DensifyInfo summed."""
    shape = {"data": 1, "gauss": 2, "tile": 1}
    mesh = jax_mesh(shape)
    store, aux, stats = (_interleave(x, 2) for x in densify_state(11))
    jstore = JG.GaussianStore(
        params=JG.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in store["params"].items()}),
        alive=jnp.asarray(store["alive"]), time=jnp.asarray(store["time"]),
        time_ind=jnp.asarray(store["time_ind"]))
    poses = joint_scene[2]
    to_params = lambda d: JG.GaussianParams(**{k: jnp.asarray(v)  # noqa: E731
                                               for k, v in d.items()})
    state = jts.init_static_state(jstore, poses)._replace(
        opt=joptim.AdamState(mu=to_params(aux["mu_params"]),
                             nu=to_params(aux["nu_params"]),
                             count=jnp.asarray(5, jnp.int32)),
        stats=jdens.DensifyStats(**{k: jnp.asarray(v)
                                    for k, v in stats.items()}))
    s_kw = dict(image_width=64, image_height=48, sh_degree=1,
                densify_grad_threshold=0.5, percent_dense=0.05)
    jdt, _, dyn_setup = _dyn_setup(joint_scene, 9)
    draws = Draws(monkeypatch, 12)
    jnew, jinfo = jsharded.make_sharded_densify(
        jts.StaticTrainerConfig(**s_kw), mesh, 3.0)(
        state, jax.random.key(5), max_screen_size=None)
    static_draws = draws.take()
    assert [d.shape for d in static_draws] == [(48, 3)] * 2

    dyn_state = jdt.state._replace(
        stats=jdens.DensifyStats(**{k: jnp.asarray(v) for k, v in (
            ("grad_accum", np.ones(64, np.float32)),
            ("denom", np.ones(64, np.float32)),
            ("max_radii2d", np.zeros(64, np.float32)))}))
    dyn_cfg = jtd.DynTrainerConfig(**dict(dyn_setup["cfg"],
                                          densify_grad_threshold=1e-6,
                                          percent_dense=0.05))
    jdnew, jdinfo = jsharded.make_sharded_dynamic_densify(dyn_cfg, mesh, 3.0)(
        dyn_state, jax.random.key(6), max_screen_size=None)
    dyn_draws = draws.take()
    assert [d.shape for d in dyn_draws] == [(32, 3)] * 2

    np_state = to_np(state)
    out = run_world(ranks.densify_both, 2, (shape, dict(
        static_cfg=s_kw, loss=STATIC_LOSS,
        static=dict(np_state, store=np_state["store"]),
        static_draws=static_draws,
        dynamic=dict(dyn_setup, cfg=dict(dyn_setup["cfg"],
                                         densify_grad_threshold=1e-6,
                                         percent_dense=0.05),
                     dyn=to_np(dyn_state)),
        dynamic_draws=dyn_draws)), backend="gloo", timeout_s=WORLD_TIMEOUT)

    for r in out:
        assert {k: int(v) for k, v in r["info"].items()} == \
            {k: int(v) for k, v in jinfo._asdict().items()}
        assert {k: int(v) for k, v in r["dyn_info"].items()} == \
            {k: int(v) for k, v in jdinfo._asdict().items()}
    info = {k: int(v) for k, v in jinfo._asdict().items()}
    assert info["num_cloned"] > 0 and info["num_split"] > 0 \
        and info["num_pruned"] > 0
    assert int(jdinfo.num_split) > 0

    def same(a, b, name):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)

    got = out[0]["state"]
    for name in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(got["store"][name],
                                      np.asarray(getattr(jnew.store, name)))
    cmp(jnew.store.params, got["store"]["params"], same, "params")
    cmp(jnew.opt.mu, got["opt"]["mu"], same, "mu")
    cmp(jnew.opt.nu, got["opt"]["nu"], same, "nu")
    cmp(jnew.stats, got["stats"], same, "stats")
    for r in out:   # every rank holds the whole dynamic state again
        dgot = r["dyn_state"]
        np.testing.assert_array_equal(dgot["store"]["alive"],
                                      np.asarray(jdnew.store.alive))
        cmp(jdnew.store.params, dgot["store"]["params"], same, "dyn params")
        cmp(jdnew.motion_coeff, dgot["motion_coeff"], same, "motion_coeff")
        cmp(jdnew.opt.mu, dgot["opt"]["mu"], same, "dyn mu")
        cmp(jdnew.opt.nu, dgot["opt"]["nu"], same, "dyn nu")
        cmp(jdnew.stats, dgot["stats"], same, "dyn stats")
