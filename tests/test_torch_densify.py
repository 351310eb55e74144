"""Parity of the port's KNN and densification with the JAX package on the
CPU: `knn` / `knn_gather`, `_rank_free_slots`, `densify_and_prune` in the
four (max_screen_size, apply_screen_size_prune) settings and at a full
store, and `reset_opacity`.

The split samples are the one random draw of densification. Both sides get
the same numpy draws: the JAX side through `jax.random.normal`, patched in
call order, the port through its `split_noise`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.ops import knn as jknn
from rodygs_tpu.train import densify as jdens
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.ops import knn as tknn
from rodygs_tpu_torch.train import densify as tdens


def T(x):
    return torch.tensor(np.array(x))


# --------------------------------------------------------------------------
# knn
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,k,block,masked", [
    (50, 70, 4, 4096, False),
    (40, 90, 8, 16, True),     # several target blocks in the JAX scan
    (30, 12, 8, 7, True),      # fewer valid targets than k: slots left -1
])
def test_knn_matches(n, m, k, block, masked):
    """Indices equal on tie-free inputs (continuous random points; equal
    distances would be ordered by each side's own tie rule), squared
    distances at rtol 1e-5."""
    rng = np.random.default_rng(n + m)
    q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    t = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) < 0.5 if masked else None
    jd, ji = jknn.knn(jnp.asarray(q), jnp.asarray(t), k=k, block_size=block,
                      valid_mask=None if valid is None else jnp.asarray(valid))
    td, ti = tknn.knn(T(q), T(t), k=k, block_size=block,
                      valid_mask=None if valid is None else T(valid))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-7)
    if valid is not None and valid.sum() < k:
        assert (ti.numpy() == -1).any()
    feats = rng.normal(size=(m, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tknn.knn_gather(T(feats), ti).numpy(),
        np.asarray(jknn.knn_gather(jnp.asarray(feats), ji)))


def test_rank_free_slots_matches():
    free = np.random.default_rng(0).uniform(size=97) < 0.3
    np.testing.assert_array_equal(
        tdens._rank_free_slots(T(free)).numpy(),
        np.asarray(jdens._rank_free_slots(jnp.asarray(free))))


# --------------------------------------------------------------------------
# densify_and_prune
# --------------------------------------------------------------------------


def _state(seed, n=60, cap=96, basis=4):
    """A store of n alive Gaussians in `cap` slots with every decision
    present: high and low screen grads, small and large scales (clone /
    split / world-size prune), low opacities, large screen radii. Returns
    numpy (store, aux, stats) in the JAX package's field layout."""
    rng = np.random.default_rng(seed)

    def pad(v):
        return np.concatenate([v, np.zeros((cap - n,) + v.shape[1:], v.dtype)])

    q = rng.normal(size=(n, 4)).astype(np.float32)
    log_scale = np.log(rng.choice([0.005, 0.02, 0.08, 0.3], size=(n, 1))
                       * rng.uniform(0.5, 1.5, (n, 3))).astype(np.float32)
    opac = rng.choice([0.001, 0.3, 0.9], size=(n, 1), p=[0.15, 0.5, 0.35])
    params = dict(
        xyz=pad(rng.normal(size=(n, 3)).astype(np.float32)),
        features_dc=pad(rng.normal(size=(n, 1, 3)).astype(np.float32)),
        features_rest=pad(rng.normal(size=(n, 3, 3)).astype(np.float32)),
        scaling=pad(log_scale),
        rotation=pad(q),
        opacity=pad(np.log(opac / (1 - opac)).astype(np.float32)))
    store = dict(params=params, alive=pad(np.ones(n, bool)),
                 time=pad(rng.choice([0.0, 0.5, 1.0], n).astype(np.float32)),
                 time_ind=pad(rng.integers(0, 3, n).astype(np.int32)))

    def like(p):
        return {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in p.items()}

    aux = {"mu_params": like(params), "nu_params": like(params),
           "coeff": rng.normal(size=(cap, 1, basis)).astype(np.float32),
           "mu_coeff": rng.normal(size=(cap, 1, basis)).astype(np.float32)}
    denom = pad(rng.integers(1, 5, n).astype(np.float32))
    accum = denom * pad(rng.choice([0.01, 0.9], n).astype(np.float32))
    radii = pad(rng.choice([2.0, 50.0], n).astype(np.float32))
    stats = dict(grad_accum=accum, denom=denom, max_radii2d=radii)
    return store, aux, stats


def _jax_tree(store, aux, stats):
    js = JG.GaussianStore(
        params=JG.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in store["params"].items()}),
        alive=jnp.asarray(store["alive"]), time=jnp.asarray(store["time"]),
        time_ind=jnp.asarray(store["time_ind"]))
    jaux = {k: (JG.GaussianParams(**{f: jnp.asarray(x) for f, x in v.items()})
                if isinstance(v, dict) else jnp.asarray(v))
            for k, v in aux.items()}
    return js, jaux, jdens.DensifyStats(**{k: jnp.asarray(v)
                                           for k, v in stats.items()})


def _torch_tree(store, aux, stats):
    taux = {k: (TG.GaussianParams(**{f: T(x) for f, x in v.items()})
                if isinstance(v, dict) else T(v)) for k, v in aux.items()}
    return (convert.store_from_numpy(store, "cpu"), taux,
            convert.stats_from_numpy(stats, "cpu"))


def _same_split_noise(monkeypatch, seed):
    """The JAX normal draws and the port's split_noise give the same numpy
    samples, in call order."""
    rng = np.random.default_rng(1000 + seed)
    draws = []

    def jax_normal(key, shape, dtype=jnp.float32):
        draws.append(rng.standard_normal(shape).astype(np.float32))
        return jnp.asarray(draws[-1])

    def port_split_noise(generator, capacity, device):
        return T(draws.pop(0)), T(draws.pop(0))

    monkeypatch.setattr(jax.random, "normal", jax_normal)
    monkeypatch.setattr(tdens, "split_noise", port_split_noise)


def _leaves(tree):
    if isinstance(tree, tuple):
        return {f: np.asarray(x) for f, x in tree._asdict().items()}
    return {"": np.asarray(tree)}


def _check_densify(old_store, jout, tout):
    js, jaux, jstats, jinfo = jout
    ts, taux, tstats, tinfo = tout
    for name in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert convert.densify_info_to_numpy(tinfo) == {
        k: int(v) for k, v in jinfo._asdict().items()}
    assert convert.densify_info_from_numpy(jinfo, "cpu") == tinfo
    alive = np.asarray(js.alive)
    # slots whose Gaussian stayed put hold exact copies; clones are copies
    # too; split children's xyz and log-scale are computed (1e-6)
    kept = (alive & old_store["alive"]
            & (np.asarray(js.params.xyz) == old_store["params"]["xyz"]).all(1))
    for name in JG.GaussianParams._fields:
        j = np.asarray(getattr(js.params, name))
        t = getattr(ts.params, name).numpy()
        np.testing.assert_array_equal(t[kept], j[kept], name)
        np.testing.assert_allclose(t[alive], j[alive], rtol=0, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(t[~alive], 0.0, name)
    for key in jaux:
        for f, j in _leaves(jaux[key]).items():
            t = _leaves(taux[key])[f]
            np.testing.assert_array_equal(t, j, f"{key}.{f}")
    for a, b in zip(jstats, tstats):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("mss", [None, 20.0])
@pytest.mark.parametrize("apply_fix", [False, True])
def test_densify_and_prune_matches(monkeypatch, mss, apply_fix):
    seed = 3 + (mss is None) + 2 * apply_fix
    store, aux, stats = _state(seed)
    _same_split_noise(monkeypatch, seed)
    kw = dict(max_grad=0.5, min_opacity=0.005, extent=1.0,
              percent_dense=0.05, max_screen_size=mss,
              apply_screen_size_prune=apply_fix)
    jout = jdens.densify_and_prune(*_jax_tree(store, aux, stats),
                                   jax.random.key(seed), **kw)
    tout = tdens.densify_and_prune(*_torch_tree(store, aux, stats),
                                   torch.Generator(), **kw)
    _check_densify(store, jout, tout)
    info = jout[3]
    assert int(info.num_cloned) > 0 and int(info.num_split) > 0
    assert int(info.num_pruned) > 0 and int(info.dropped) == 0
    if mss is not None and apply_fix:   # the screen-radius prune fires
        assert int(info.num_pruned) > int(jdens.densify_and_prune(
            *_jax_tree(store, aux, stats), jax.random.key(seed),
            **{**kw, "apply_screen_size_prune": False})[3].num_pruned)


def test_densify_and_prune_full_store(monkeypatch):
    """More new Gaussians than free slots: the surplus is dropped and
    counted the same on both sides."""
    store, aux, stats = _state(11, n=90)
    _same_split_noise(monkeypatch, 11)
    kw = dict(max_grad=0.5, min_opacity=0.0, extent=1.0, percent_dense=0.05,
              max_screen_size=None)
    jout = jdens.densify_and_prune(*_jax_tree(store, aux, stats),
                                   jax.random.key(0), **kw)
    tout = tdens.densify_and_prune(*_torch_tree(store, aux, stats),
                                   torch.Generator(), **kw)
    _check_densify(store, jout, tout)
    assert int(tout[3].dropped) > 0
    assert int(TG.num_alive(tout[0])) == int(JG.num_alive(jout[0])) == 96


def test_reset_opacity_matches():
    store, aux, _ = _state(5)
    js, jaux, _ = _jax_tree(store, aux, {"grad_accum": 0, "denom": 0,
                                         "max_radii2d": 0})
    ts = convert.store_from_numpy(store, "cpu")
    jo = jdens.reset_opacity(js, jaux["mu_params"].opacity,
                             jaux["nu_params"].opacity)
    to = tdens.reset_opacity(ts, T(aux["mu_params"]["opacity"]),
                             T(aux["nu_params"]["opacity"]))
    np.testing.assert_allclose(to[0].params.opacity.numpy(),
                               np.asarray(jo[0].params.opacity), rtol=1e-6)
    assert not to[1].any() and not to[2].any()


def test_static_train_iteration_densifies_and_resets():
    """The static trainer densifies and resets opacity on their schedule
    (iteration 4: from 2, every 2; reset every 4) instead of raising."""
    from rodygs_tpu_torch.train import losses as tlosses
    from rodygs_tpu_torch.train import optim as toptim
    from rodygs_tpu_torch.train import trainer_static as tts

    rng = np.random.default_rng(2)
    store = TG.from_point_cloud(
        rng.uniform([-1, -1, 3], [1, 1, 5], (40, 3)).astype(np.float32),
        rng.uniform(0.1, 0.9, (40, 3)).astype(np.float32), 1, capacity=64,
        device="cpu")
    poses = toptim.CameraPoses(torch.tensor([[1.0, 0, 0, 0]]),
                               torch.zeros((1, 3)))
    cfg = tts.StaticTrainerConfig(
        image_width=32, image_height=24, sh_degree=1, densify_from_iter=2,
        densification_interval=2, opacity_reset_interval=4,
        densify_grad_threshold=0.0)
    trainer = tts.ThreeDGSTrainer(
        cfg, tlosses.MultiLoss([tlosses.LossTerm("l1", 1.0, "L1Loss")]),
        store, poses, 1.0, device="cpu", seed=3)
    batch = tts.FrameBatch(gt_image=torch.full((24, 32, 3), 0.5),
                           gt_depth=None, motion_mask=None, frame_idx=0,
                           time=torch.tensor(0.0), fovx=torch.tensor(0.9),
                           fovy=torch.tensor(0.7))
    assert "densify" not in trainer.train_iteration(batch, 3)
    info = trainer.train_iteration(batch, 4)["densify"]
    # every alive gaussian passes a zero threshold: 40 clones or splits, of
    # which the 24 free slots (and the split parents' slots) take what fits
    assert int(info.num_cloned) + int(info.num_split) == 40
    st = trainer.state
    assert int(TG.num_alive(st.store)) == 64 and int(info.dropped) > 0
    assert float(TG.get_opacity(st.store.params)[st.store.alive].max()) <= 0.01 + 1e-6
    assert not st.opt.mu.opacity.any() and not st.opt.nu.opacity.any()
    assert not st.stats.denom.any()
