"""Parity of the port's dynamic stage with the JAX package on the CPU: the
new loss terms (values and gradients), the motion model, `MultiLoss.from_config`
on the kubric loss lists, and one joint RoDyGS iteration (static step, static
densification, dynamic step with rigidity, dynamic densification) from
identical state.

Randomness: the JAX package draws from split keys, the port from one
`torch.Generator` per trainer, so the draws are replaced on both sides by
the same numpy draws. The JAX side gets them through `jax.random.normal`,
`randint` and `permutation`, patched in call order; the port through the
functions that hold its draws (`densify.split_noise`, `losses.box_origins`,
`losses.rigidity_permutation`, `losses.rigidity_times`).

The motion net's time features: with t_emb_multires frequencies up to
2^(M-1)*pi, t*f reaches 2^25*pi at the shipped M = 26, where the float32
rounding of the argument decides the feature; the port builds the
frequency table with XLA's bits (models/motion.xla_linspace), so parity is
taken up to M = 26 (every embedding column and the basis at atol 1e-5),
the JAX side jitted as its trainers run it.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.models import motion as JM
from rodygs_tpu.ops import image as jimage
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_dynamic as jtd
from rodygs_tpu.train import trainer_joint as jtj
from rodygs_tpu.train import trainer_static as jts
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.models import motion as TM
from rodygs_tpu_torch.ops import image as timage
from rodygs_tpu_torch.render import camera as tcamera
from rodygs_tpu_torch.render.rasterize import render as trender
from rodygs_tpu_torch.train import densify as tdens
from rodygs_tpu_torch.train import losses as tlosses
from rodygs_tpu_torch.train import trainer_dynamic as ttd
from rodygs_tpu_torch.train import trainer_joint as ttj
from rodygs_tpu_torch.train import trainer_static as tts

W, H = 64, 48
GRAD_TOL = 5e-4
KUBRIC = "configs/train/train_kubric_mrig.yaml"


def T(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def assert_scaled(a, b, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-8
    np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL, err_msg=name)


class SameDraws:
    """The JAX package's draws, recorded in call order from one numpy
    generator, then replayed to the port's draw functions."""

    def __init__(self, monkeypatch, seed):
        self.rng = np.random.default_rng(seed)
        self.log = []
        mp = monkeypatch
        mp.setattr(jax.random, "normal", self._normal)
        mp.setattr(jax.random, "randint", self._randint)
        mp.setattr(jax.random, "permutation", self._permutation)
        mp.setattr(tdens, "split_noise",
                   lambda gen, c, dev: (self._pop("normal"), self._pop("normal")))
        mp.setattr(tlosses, "box_origins",
                   lambda gen, n, h, w, p, dev: (self._pop("randint"),
                                                 self._pop("randint")))
        mp.setattr(tlosses, "rigidity_permutation",
                   lambda gen, c, dev: self._pop("permutation"))
        mp.setattr(tlosses, "rigidity_times",
                   lambda gen, n, num_t, dev: self._pop("randint"))

    def _record(self, kind, value):
        self.log.append((kind, value))
        return jnp.asarray(value)

    def _normal(self, key, shape, dtype=jnp.float32):
        return self._record("normal",
                            self.rng.standard_normal(shape).astype(np.float32))

    def _randint(self, key, shape, minval, maxval, dtype=jnp.int32):
        return self._record("randint", self.rng.integers(
            minval, maxval, shape).astype(np.int32))

    def _permutation(self, key, x, *args, **kwargs):
        return self._record("permutation",
                            self.rng.permutation(int(x)).astype(np.int32))

    def _pop(self, kind):
        got, value = self.log.pop(0)
        assert got == kind, (got, kind)
        return torch.tensor(value).long() if kind != "normal" else torch.tensor(value)

    def kinds(self):
        return [k for k, _ in self.log]


# --------------------------------------------------------------------------
# loss terms
# --------------------------------------------------------------------------


def _term_parity(monkeypatch, jfn, tfn, arrays, grad_keys, **params):
    """Value (rtol 1e-5) and gradients (scaled by their max, 5e-4) of one
    loss term on the same numpy inputs and draws."""
    SameDraws(monkeypatch, 17)
    fixed = {k: jnp.asarray(v) for k, v in arrays.items() if k not in grad_keys}

    def jloss(*g):
        ctx = {**fixed, **dict(zip(grad_keys, g)), "rng": jax.random.key(0)}
        return jfn(ctx, **params)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=tuple(
        range(len(grad_keys)))))(*[jnp.asarray(arrays[k]) for k in grad_keys])
    tin = {k: T(v, k in grad_keys) for k, v in arrays.items()}
    tval = tfn({**tin, "rng": torch.Generator()}, **params)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-5, atol=1e-7)
    if grad_keys:
        tgrads = torch.autograd.grad(tval, [tin[k] for k in grad_keys],
                                     allow_unused=True)
        for k, jg, tg in zip(grad_keys, jgrads, tgrads):
            tg = torch.zeros_like(tin[k]) if tg is None else tg
            assert np.isfinite(tg.numpy()).all(), k
            assert_scaled(jg, tg.numpy(), k)
    return float(jval)


@pytest.mark.parametrize("mode", [None, "static", "dynamic"])
def test_global_pearson_depth_matches(monkeypatch, mode):
    rng = np.random.default_rng(1)
    pred = rng.uniform(1, 5, (H, W)).astype(np.float32)
    arrays = {"pred_depth": pred,
              "gt_depth": (2 * pred + rng.normal(0, 2.0, (H, W))).astype(np.float32),
              "motion_mask": (rng.uniform(size=(H, W)) > 0.7).astype(np.float32)}
    _term_parity(monkeypatch, jlosses.global_pearson_depth,
                 tlosses.global_pearson_depth, arrays, ["pred_depth"], mode=mode)


def test_local_pearson_depth_matches(monkeypatch):
    rng = np.random.default_rng(2)
    pred = rng.uniform(1, 5, (H, W)).astype(np.float32)
    arrays = {"pred_depth": pred,
              "gt_depth": (pred + rng.normal(0, 1.0, (H, W))).astype(np.float32)}
    _term_parity(monkeypatch, jlosses.local_pearson_depth,
                 tlosses.local_pearson_depth, arrays, ["pred_depth"],
                 box_p=16, p_corr=0.5)


def test_charbonnier_matches():
    rng = np.random.default_rng(3)
    x, y = (rng.normal(size=(20, 3, 1)).astype(np.float32) for _ in range(2))
    for norm in ("bc", "b", "i", ""):
        np.testing.assert_allclose(
            timage.charbonnier_loss(T(x), T(y), out_norm=norm).item(),
            float(jimage.charbonnier_loss(jnp.asarray(x), jnp.asarray(y),
                                          out_norm=norm)), rtol=1e-6)


def _motion_arrays(seed, n=64, b=4, t=6):
    rng = np.random.default_rng(seed)
    alive = rng.uniform(size=n) < 0.8
    return {
        "canon_xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "pred_translation": rng.normal(0, 0.05, (n, 3)).astype(np.float32),
        "motion_coeff": rng.normal(0, 0.3, (n, 1, b)).astype(np.float32),
        "features_dc": rng.uniform(size=(n, 1, 3)).astype(np.float32),
        "alive": alive,
        "motion_table": rng.normal(0, 0.05, (t, b, 7)).astype(np.float32),
    }


@pytest.mark.parametrize("fn", ["motion_l1", "motion_sparsity"])
def test_motion_coeff_terms_match(monkeypatch, fn):
    _term_parity(monkeypatch, getattr(jlosses, fn), getattr(tlosses, fn),
                 _motion_arrays(4), ["motion_coeff"])


@pytest.mark.parametrize("params", [
    dict(K=4, mode=("distance_preserving", "surface")),   # the kubric modes
    dict(K=4, mode=("coeff",), sim_metric="l2"),
    dict(K=3, mode=("coeff",), sim_metric="l1", color_sim=False),
    dict(K=4, mode=("coeff",), sim_metric="cosine", scale=1.0),
])
def test_rigidity_matches(monkeypatch, params):
    keys = ["canon_xyz", "pred_translation", "motion_coeff", "features_dc",
            "motion_table"]
    val = _term_parity(monkeypatch, jlosses.rigidity, tlosses.rigidity,
                       _motion_arrays(5, t=9), keys, **params)
    assert val > 0


@pytest.mark.parametrize("freq_div_mode,td,rd,matmul", [
    ("cum_exponential", 0, 0, False),   # the kubric setting
    ("gaussian", 1, 0, False),
    ("vanilla", 0, 1, True),
    ("laplacian", -1, 0, False),
])
def test_motion_basis_reg_matches(monkeypatch, freq_div_mode, td, rd, matmul):
    arrays = {"motion_table": _motion_arrays(6, b=16, t=7)["motion_table"]}
    _term_parity(monkeypatch, jlosses.motion_basis_reg, tlosses.motion_basis_reg,
                 arrays, ["motion_table"], transl_degree=td, rot_degree=rd,
                 freq_div_mode=freq_div_mode, apply_rot_matmul_derivative=matmul)


def _kubric_loss_lists():
    with open(KUBRIC) as f:
        trainer = yaml.safe_load(f)["trainer"]["params"]
    return {stage: trainer[stage]["params"]["loss_config"]["params"]["loss_configs"]
            for stage in ("static", "dynamic")}


def test_multiloss_from_config_matches():
    def fields(term):
        return (term.name, term.weight, term.fn_name, term.freq, term.start,
                term.params)

    for stage, lst in _kubric_loss_lists().items():
        j = jlosses.MultiLoss.from_config(lst)
        t = tlosses.MultiLoss.from_config(lst)
        assert [fields(x) for x in t.terms] == [fields(x) for x in j.terms]
        for it in (1, 5, 600):
            assert t.active_set(it) == j.active_set(it)
    names = [x.fn_name for x in tlosses.MultiLoss.from_config(
        _kubric_loss_lists()["dynamic"]).terms]
    assert "RigidityLoss" in names and "MotionBasisRegularizaiton" in names


# --------------------------------------------------------------------------
# motion model
# --------------------------------------------------------------------------


def _net(cfg, seed):
    params = JM.init_motion_params(jax.random.key(seed), cfg)
    return params, convert.net_from_numpy(params, "cpu")


@pytest.mark.parametrize("multires,log_s", [(6, False), (15, False),
                                            (26, False), (10, True)])
def test_motion_model_matches(multires, log_s):
    cfg = JM.MotionNetConfig(netwidth=32, num_basis=4, t_emb_multires=multires,
                             t_log_sampling=log_s)
    tcfg = TM.MotionNetConfig(*cfg)
    jp, tp = _net(cfg, 3)
    # heads large enough that the basis is not ~0
    rng = np.random.default_rng(8)
    for k in ("w0", "w1"):
        jp["heads"][k] = jnp.asarray(rng.normal(0, 0.3, jp["heads"][k].shape),
                                     jnp.float32)
        tp["heads"][k] = T(jp["heads"][k])
    times = np.array([0.0, 0.13, 0.5, 0.97], np.float32)
    np.testing.assert_allclose(
        TM.embed_time(T(times), multires, log_s).numpy(),
        np.asarray(jax.jit(JM.embed_time, static_argnums=(1, 2))(
            jnp.asarray(times), multires, log_s)), atol=1e-5)
    np.testing.assert_allclose(
        TM.motion_table(tp, tcfg, T(times)).numpy(),
        np.asarray(jax.jit(JM.motion_table, static_argnums=1)(
            jp, cfg, jnp.asarray(times))), atol=1e-5)
    jdeform = jax.jit(JM.gaussian_deformation, static_argnums=(1, 4, 5))
    n = 40
    coeff = rng.normal(0, 0.5, (n, 1, 4)).astype(np.float32)
    tind = rng.integers(0, len(times), n).astype(np.int32)
    for inverse in (False, True):
        jt, jr = jdeform(jp, cfg, jnp.asarray(coeff), jnp.float32(0.42), 3.7,
                         inverse, jnp.asarray(tind), jnp.asarray(times))
        tt, tr = TM.gaussian_deformation(
            tp, tcfg, T(coeff), 0.42, 3.7, inverse_motion=inverse,
            time_ind=T(tind), times_table=T(times))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_motion_model_shipped_width_bounded():
    """At the shipped 26 frequencies: bounded features and finite
    gradients."""
    cfg = TM.MotionNetConfig()
    net = TM.init_motion_params(0, cfg, device="cpu")
    times = torch.linspace(0, 1, 9)
    emb = TM.embed_time(times, 26, False)
    assert emb.shape == (9, 53) and float(emb[:, 1:].abs().max()) <= 1.0
    leaves = [net["timenet"]["w0"], net["heads"]["w1"]]
    for x in leaves:
        x.requires_grad_(True)
    table = TM.motion_table(net, cfg, times)
    assert table.shape == (9, 16, 7)
    grads = torch.autograd.grad(table.square().sum(), leaves)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


# --------------------------------------------------------------------------
# one joint iteration from identical state
# --------------------------------------------------------------------------

N_STATIC, N_DYN, CAP_S, CAP_D = 50, 12, 128, 64
ITERATION = 600   # densification of both models (from 500, every 100) and
                  # rigidity (every 5th) fire together


def _jax_store(store):
    """A JAX GaussianStore from the port's."""
    f = convert.store_to_numpy(store)
    return JG.GaussianStore(
        params=JG.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in f["params"].items()}),
        alive=jnp.asarray(f["alive"]), time=jnp.asarray(f["time"]),
        time_ind=jnp.asarray(f["time_ind"]))


def _joint_scene():
    """Static points + dynamic points born at t in {0, 0.5, 1} moving with a
    seeded velocity; the GT image and an affinely distorted depth, rendered
    by the port at t = 0.25 from camera 1 of 3. Returns the JAX package's
    stores and poses."""
    rng = np.random.default_rng(5)
    f32 = lambda x: np.asarray(x, np.float32)
    sm = f32(rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5], (N_STATIC, 3)))
    dm = f32(rng.uniform([-0.8, -0.5, 2.8], [0.8, 0.5, 3.8], (N_DYN, 3)))
    vel = f32(rng.uniform(-0.4, 0.4, (N_DYN, 3)))
    sc = f32(rng.uniform(0.1, 0.9, (N_STATIC, 3)))
    dc = f32(rng.uniform(0.1, 0.9, (N_DYN, 3)))
    static = TG.from_point_cloud(sm, sc, sh_degree=1, capacity=CAP_S,
                                 device="cpu")
    dyn = TG.from_point_cloud(dm, dc, sh_degree=1, capacity=CAP_D,
                              times=f32(rng.choice([0.0, 0.5, 1.0], N_DYN)),
                              device="cpu")
    angles = (-0.05, 0.0, 0.05)
    poses = joptim.CameraPoses(
        q_c2w=jnp.asarray([[np.cos(a / 2), 0, np.sin(a / 2), 0] for a in angles],
                          jnp.float32),
        t_c2w=jnp.asarray([[np.sin(a) * 3.0, 0, 0] for a in angles], jnp.float32))
    t = 0.25
    moved = dyn.params._replace(
        xyz=dyn.params.xyz + F.pad(T(vel * t), (0, 0, 0, CAP_D - N_DYN)),
        opacity=torch.full_like(dyn.params.opacity, 2.0))
    p = TG.GaussianParams(*[torch.cat(x) for x in zip(static.params, moved)])
    cam = tcamera.make_camera(T(poses.q_c2w[1]), T(poses.t_c2w[1]), 0.9, 0.7, t,
                              device="cpu")
    with torch.no_grad():
        out = trender(p.xyz, TG.get_features(p), TG.get_opacity(p),
                      TG.get_scaling(p), p.rotation, cam, 1, W, H,
                      alive=torch.cat([static.alive, dyn.alive]))
    img = f32(np.clip(out["rendered_image"].numpy()
                      + rng.normal(0, 0.05, (H, W, 3)), 0, 1))
    depth = f32(1.7 * out["rendered_depth"].numpy() + 0.3
                + rng.normal(0, 0.05, (H, W)))
    return _jax_store(static), _jax_store(dyn), poses, img, depth, t


def _seeded_adam(rng, params, count=10, scale=0.1):
    """Adam state with non-zero moments, so the step is a smooth function of
    the gradient (a first step from zero moments is lr * sign(g))."""
    def m(x):
        return jnp.asarray(rng.normal(0, scale, x.shape), jnp.float32)

    def v(x):
        return jnp.asarray(scale**2 * rng.uniform(1, 4, x.shape), jnp.float32)

    return joptim.AdamState(mu=jax.tree.map(m, params),
                            nu=jax.tree.map(v, params),
                            count=jnp.asarray(count, jnp.int32))


def _seeded_stats(rng, alive, high_share):
    """Accumulated statistics whose mean gradient sits far from the 2e-4
    threshold on either side: denom 1000 dilutes one step's addition."""
    n = alive.shape[0]
    denom = np.where(alive, 1000.0, 0.0).astype(np.float32)
    high = rng.uniform(size=n) < high_share
    accum = denom * np.where(high, 0.01, 1e-7).astype(np.float32)
    return jts.DensifyStats(grad_accum=jnp.asarray(accum),
                            denom=jnp.asarray(denom),
                            max_radii2d=jnp.asarray(
                                rng.uniform(0, 9, n).astype(np.float32)))


def _capture(obj, attr, into):
    fn = getattr(obj, attr)

    def wrapped(state, *args, **kwargs):
        into.append(copy.copy(state))
        return fn(state, *args, **kwargs)

    setattr(obj, attr, wrapped)


def _cmp_params(jp, tp, what):
    for name in JG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tp, name).detach().numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{what}.{name}")


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of NamedTuples, dicts, JAX arrays and
    tensors; paths name fields and keys, so the two sides' leaf orders
    need not agree."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _cmp_trees(jtree, ttree, check, what):
    jf, tf = _flat(jtree, what), _flat(ttree, what)
    assert sorted(jf) == sorted(tf), what
    for k in jf:
        check(jf[k], tf[k], k)


def _close(a, b, name):
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)


def _reference_units(monkeypatch):
    """The JAX package adds `means2d_offset` / (0.5*[W, H]) to the projected
    means where the port (as the reference) adds offset * 0.5*[W, H]: the
    JAX trainers' offsets are scaled by (0.5*[W, H])^2 here, so both sides'
    densification statistics come in the reference's units."""
    def render(*args, means2d_offset=None, **kwargs):
        w, h = args[7], args[8]
        ndc2 = jnp.asarray([[(0.5 * w) ** 2], [(0.5 * h) ** 2]], jnp.float32)
        return jrender(*args, means2d_offset=means2d_offset * ndc2, **kwargs)

    monkeypatch.setattr(jts, "render", render)
    monkeypatch.setattr(jtj, "render", render)


def test_joint_iteration_matches(monkeypatch):
    static, dyn, poses, img, depth, t = _joint_scene()
    lists = _kubric_loss_lists()
    for lst in lists.values():   # the kubric lists at 64x48 and K = 4
        for term in lst:
            p = term.get("params") or {}
            if "box_p" in p:
                p["box_p"] = 16
            if "K" in p:
                p["K"] = 4
    # the kubric trainer settings (configs/train/train_kubric_mrig.yaml) at
    # the test's sizes
    s_kw = dict(image_width=W, image_height=H, sh_degree=1)
    d_kw = dict(s_kw, scaling_lr=0.001, densify_until_iter=15000,
                camera_rotation_lr=0.0, camera_translation_lr=0.0,
                deform_netwidth=32, deform_t_emb_multires=6, num_basis=4)
    jst = jts.ThreeDGSTrainer(jts.StaticTrainerConfig(**s_kw),
                              jlosses.MultiLoss.from_config(lists["static"]),
                              static, poses, 3.0)
    jdt = jtd.DynTrainer(jtd.DynTrainerConfig(**d_kw),
                         jlosses.MultiLoss.from_config(lists["dynamic"]),
                         dyn, 3.0, jax.random.key(7))
    jjoint = jtj.RoDyGSTrainer(jst, jdt, sh_up_start_iteration=15000)

    rng = np.random.default_rng(9)
    jst.state = jst.state._replace(
        opt=_seeded_adam(rng, jst.state.store.params),
        cam_opt=_seeded_adam(rng, jst.state.poses, scale=0.01),
        stats=_seeded_stats(rng, np.asarray(static.alive), 0.3))
    coeff = jnp.asarray(rng.normal(0, 0.3, jdt.state.motion_coeff.shape)
                        * np.asarray(dyn.alive)[:, None, None], jnp.float32)
    jdt.state = jdt.state._replace(
        motion_coeff=coeff,
        opt=_seeded_adam(rng, jtd.DynParams(dyn.params, coeff, jdt.state.net)),
        stats=_seeded_stats(rng, np.asarray(dyn.alive), 0.4))
    jst.active_sh_degree = 1

    tst = tts.ThreeDGSTrainer(tts.StaticTrainerConfig(**s_kw),
                              tlosses.MultiLoss.from_config(lists["static"]),
                              convert.store_from_numpy(static, "cpu"),
                              convert.poses_from_numpy(poses, "cpu"), 3.0,
                              device="cpu")
    tdt = ttd.DynTrainer(ttd.DynTrainerConfig(**d_kw),
                         tlosses.MultiLoss.from_config(lists["dynamic"]),
                         convert.store_from_numpy(dyn, "cpu"), 3.0,
                         device="cpu")
    tjoint = ttj.RoDyGSTrainer(tst, tdt, sh_up_start_iteration=15000)
    tst.state = tst.state._replace(
        opt=convert.adam_from_numpy(jst.state.opt, tts.G.GaussianParams, "cpu"),
        cam_opt=convert.adam_from_numpy(jst.state.cam_opt, tts.CameraPoses,
                                        "cpu"),
        stats=convert.stats_from_numpy(jst.state.stats, "cpu"))
    tdt.state = convert.dyn_state_from_numpy(jdt.state, "cpu")
    back = _flat(convert.dyn_state_to_numpy(tdt.state))
    assert back.keys() == _flat(jdt.state).keys()
    for k, v in _flat(jdt.state).items():
        np.testing.assert_array_equal(back[k], v, k)
    tst.active_sh_degree = 1
    np.testing.assert_array_equal(tdt.unique_times.numpy(),
                                  np.asarray(jdt.unique_times))

    j_pre, t_pre = {"s": [], "d": []}, {"s": [], "d": []}
    _capture(jst, "_densify_fn", j_pre["s"])
    _capture(jdt, "_densify_fn", j_pre["d"])
    _capture(tst, "densify", t_pre["s"])
    _capture(tdt, "densify", t_pre["d"])
    draws = SameDraws(monkeypatch, 21)
    _reference_units(monkeypatch)

    jb = jts.FrameBatch(gt_image=jnp.asarray(img), gt_depth=jnp.asarray(depth),
                        motion_mask=None, frame_idx=jnp.asarray(1),
                        time=jnp.asarray(t, jnp.float32),
                        fovx=jnp.asarray(0.9), fovy=jnp.asarray(0.7))
    tb = tts.FrameBatch(gt_image=T(img), gt_depth=T(depth), motion_mask=None,
                        frame_idx=1, time=torch.tensor(t), fovx=torch.tensor(0.9),
                        fovy=torch.tensor(0.7))
    jm = jjoint.train_iteration(jb, jb, ITERATION, jax.random.key(0))
    # static: 2 box draws; static split; dynamic: permutation, time sample,
    # 2 box draws; dynamic split
    assert draws.kinds() == (["randint"] * 2 + ["normal"] * 2
                             + ["permutation"] + ["randint"] * 3
                             + ["normal"] * 2)
    tm = tjoint.train_iteration(tb, tb, ITERATION)
    assert draws.kinds() == []

    # losses, every term
    for stage in ("static", "dynamic"):
        assert sorted(tm[stage]) == sorted(jm[stage])
        for k in jm[stage]:
            if k in ("overflow", "dropped", "num_fragments"):
                assert int(tm[stage][k]) == int(jm[stage][k]), (stage, k)
            else:
                np.testing.assert_allclose(float(tm[stage][k]),
                                           float(jm[stage][k]), rtol=1e-5,
                                           err_msg=f"{stage}.{k}")
    assert "rigidity" in tm["dynamic"] and "motion_basis_reg" in tm["dynamic"]

    # post-step state, as densification found it
    (js,), (ts,) = j_pre["s"], t_pre["s"]
    (jd,), (td,) = j_pre["d"], t_pre["d"]
    _cmp_params(js.store.params, ts.store.params, "static")
    for name in ("q_c2w", "t_c2w"):
        np.testing.assert_allclose(getattr(ts.poses, name).numpy(),
                                   np.asarray(getattr(js.poses, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    _cmp_params(jd.store.params, td.store.params, "dynamic")
    _cmp_trees(jd.motion_coeff, td.motion_coeff, _close, "motion_coeff")
    _cmp_trees(jd.net, td.net, _close, "net")
    for jstate, tstate in ((js, ts), (jd, td)):
        assert int(tstate.opt.count) == int(jstate.opt.count) == 11
        for moment in ("mu", "nu"):
            _cmp_trees(getattr(jstate.opt, moment), getattr(tstate.opt, moment),
                       assert_scaled, moment)
        assert_scaled(jstate.stats.grad_accum, tstate.stats.grad_accum.numpy())
        np.testing.assert_array_equal(tstate.stats.denom.numpy(),
                                      np.asarray(jstate.stats.denom))
        np.testing.assert_array_equal(tstate.stats.max_radii2d.numpy(),
                                      np.asarray(jstate.stats.max_radii2d))
        # the densify decisions stand well clear of the 2e-4 threshold
        mean_g = np.asarray(jstate.stats.grad_accum) / np.maximum(
            np.asarray(jstate.stats.denom), 1)
        on = np.asarray(jstate.store.alive)
        assert (np.abs(mean_g[on] / 2e-4 - 1) > 0.1).all()

    # post-densify stores
    for key, jinfo_key, jstate, tstate in (
            ("static_densify", "static_densify", jst.state, tst.state),
            ("dynamic_densify", "dynamic_densify", jdt.state, tdt.state)):
        jinfo = {k: int(v) for k, v in jm[jinfo_key]._asdict().items()}
        assert convert.densify_info_to_numpy(tm[key]) == jinfo, key
        assert jinfo["num_cloned"] + jinfo["num_split"] > 0, key
        for name in ("alive", "time", "time_ind"):
            np.testing.assert_array_equal(getattr(tstate.store, name).numpy(),
                                          np.asarray(getattr(jstate.store, name)))
        _cmp_params(jstate.store.params, tstate.store.params, key)
    _cmp_trees(jdt.state.motion_coeff, tdt.state.motion_coeff, _close,
               "motion_coeff")
    for jstate, tstate in ((jst.state, tst.state), (jdt.state, tdt.state)):
        for moment in ("mu", "nu"):
            _cmp_trees(getattr(jstate.opt, moment), getattr(tstate.opt, moment),
                       assert_scaled, moment)
    assert tdt.active_sh_degree == jdt.active_sh_degree == 1

    # the checkpoint payloads: the same layout, the same model section; a
    # store restored from the port's model section on either side
    for jtr, ttr in ((jst, tst), (jdt, tdt)):
        jsd = _flat(jtr.state_dict(ITERATION))
        tsd = _flat(ttr.state_dict(ITERATION))
        assert sorted(jsd) == sorted(tsd)
        for k in jsd:
            if k.startswith(".model."):
                np.testing.assert_allclose(tsd[k], jsd[k], rtol=1e-6,
                                           atol=1e-6, err_msg=k)
    sd = {k: v.numpy() for k, v in TG.to_state_dict(tdt.state.store).items()}
    for restored in (TG.from_state_dict(sd, device="cpu"),
                     JG.from_state_dict(sd)):
        assert _flat(restored).keys() == _flat(jdt.state.store).keys()
        for k, v in _flat(restored).items():
            np.testing.assert_array_equal(v, _flat(tdt.state.store)[k])
