"""The port's multi-device and sort tools against the JAX package's scripts,
on the CPU:

  * tools/scaling_bench: `candidate_meshes` equal to the JAX script's for
    1..8 ranks; `build_scene` equal to the JAX script's arrays (the KNN
    scale prior within its float32 rounding bound, as in
    tests/test_torch_pipeline.py); the sweep
    in a 2-rank Gloo world at 96x64 / 1,500 gaussians (the baseline on one
    rank, 1x1x2, 1x2x1, 2x1x1): well-formed rows, the efficiency formula,
    each mesh's first-step loss against the JAX script's `bench_mesh` on
    the same mesh shape over the virtual CPU devices (1e-5 relative, the
    bar of tests/test_torch_sharded.py); the tool exiting 1 when a mesh
    fails;
  * tools/measure_dyn_replication at capacity 1,024: the store the JAX
    script builds, and the deformation's surrogate loss, its gradients
    (5e-4 scaled by their max) and one Adam update (5e-5) against the JAX
    script's functions on the same parameters;
  * tools/sort_microbench: the inputs bit-equal to the JAX scripts', the
    sorted key / iota / rows equal to `lax.sort(..., is_stable=True)` at
    C = 4,096 (1-D, every variant) and [4, 1024], and a chain of three
    data-dependent sorts equal to the JAX script's `chained_sort`;
  * tools/multihost_smoke --ranks 2 --backend gloo --device cpu: both
    workers' losses equal to the one-process dry run's.

The tools' --help without JAX is tested with the other tools
(tests/test_torch_tools.py). torch runs on one thread here.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.parallel import sharded as jsharded
from rodygs_tpu.train import losses as jlosses
from rodygs_tpu.train import optim as joptim
from rodygs_tpu.train import trainer_dynamic as jtd
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.parallel.dryrun import run_world
from rodygs_tpu_torch.render.compact import sort_fragments
from rodygs_tpu_torch.tools import measure_dyn_replication as MDR
from rodygs_tpu_torch.tools import multihost_smoke as MS
from rodygs_tpu_torch.tools import scaling_bench as SB
from rodygs_tpu_torch.tools import sort_microbench as SM
from rodygs_tpu_torch.train.optim import adam_init, tree_leaves

import torch_parallel_ranks as ranks
from test_torch_pipeline import _cmp_store as cmp_store

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import scaling_bench as jsb  # noqa: E402
import sort_microbench as jsm1  # noqa: E402
import sort_microbench2 as jsm2  # noqa: E402
import sort_microbench3 as jsm3  # noqa: E402

W, H, N = 96, 64, 1500
SHAPES = [(1, 1, 1), (1, 1, 2), (1, 2, 1), (2, 1, 1)]
WORLD_TIMEOUT = 240.0
GRAD_TOL, PARAM_TOL = 5e-4, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


# --------------------------------------------------------------------------
# scaling_bench
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_candidate_meshes_match_jax(n):
    for gauss in (True, False):
        assert SB.candidate_meshes(n, gauss) == jsb.candidate_meshes(n, gauss)


@pytest.fixture(scope="module")
def jax_scene():
    return jsb.build_scene(N, W, H, n_frames=8)


def test_build_scene_matches_jax(jax_scene):
    jstore, jposes, jframes = jax_scene
    store, poses, frames = SB.build_scene(N, W, H, n_frames=8, device="cpu")
    pts = np.random.default_rng(0).uniform(
        [-2.0, -1.5, 2.5], [2.0, 1.5, 7.0], size=(N, 3)).astype(np.float32)
    cmp_store(jstore, store, "store", pts)
    for k, v in flat(jposes).items():
        np.testing.assert_array_equal(flat(poses)[k], v, err_msg=k)
    assert len(frames) == len(jframes) == 8
    for f, jf in zip(frames, jframes):
        np.testing.assert_array_equal(f.gt_image.numpy(),
                                      np.asarray(jf.gt_image))
        assert f.frame_idx == int(jf.frame_idx) and f.gt_depth is None
        for k in ("time", "fovx", "fovy"):
            assert float(getattr(f, k)) == float(getattr(jf, k))


@pytest.fixture(scope="module")
def sweep():
    """The port's sweep in a 2-rank Gloo world: both ranks' summaries."""
    argv = ["--device", "cpu", "--width", str(W), "--height", str(H),
            "--n", str(N), "--iters", "1"]
    return run_world(ranks.scaling_sweep, 2, (argv,), backend="gloo",
                     timeout_s=WORLD_TIMEOUT)


def test_sweep_rows_and_efficiency(sweep):
    summary = sweep[0]
    assert sweep[1]["meshes"] == summary["meshes"]
    assert summary["n_devices"] == 2 and summary["failed"] == []
    rows = {tuple(r["mesh"][k] for k in ("data", "gauss", "tile")): r
            for r in summary["meshes"]}
    assert list(rows) == SHAPES
    for shape, r in rows.items():
        assert "error" not in r, (shape, r)
        assert r["step_ms"] > 0 and r["rays_per_s"] > 0
        used = shape[0] * shape[1] * shape[2]
        assert len(r["first_loss"]) == len(r["launches"]) == used
        # every rank of a mesh reports the mesh's loss
        assert len(set(r["first_loss"])) == 1
        np.testing.assert_allclose(
            r["rays_per_s"], shape[0] * W * H / (r["step_ms"] / 1e3),
            rtol=1e-3)
    assert rows[(1, 1, 1)]["efficiency"] == 1.0
    assert summary["baseline_rays_per_s"] == rows[(1, 1, 1)]["rays_per_s"]
    # efficiency = rays / (baseline * ranks used); as in
    # tests/test_scaling_bench.py no bound on its size (a shared host)
    for shape in SHAPES[1:]:
        eff = rows[shape]["efficiency"]
        assert 0 < eff < 100
        np.testing.assert_allclose(
            eff, rows[shape]["rays_per_s"]
            / (summary["baseline_rays_per_s"] * 2), atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
def test_sweep_first_loss_matches_jax(sweep, jax_scene, shape, monkeypatch):
    """The JAX script's `bench_mesh` on the same shape (a sub-mesh of the
    virtual CPU devices), its warm-up step's loss recorded."""
    seen = []
    make = jsharded.make_sharded_static_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def call(*a, **k):
            out = step(*a, **k)
            seen.append(float(out[1]["loss"]))
            return out
        return call

    monkeypatch.setattr(jsharded, "make_sharded_static_step", recording)
    jsb.bench_mesh(shape, *jax_scene, W, H, 1, "lean")
    row = next(r for r in sweep[0]["meshes"]
               if tuple(r["mesh"].values()) == shape)
    np.testing.assert_allclose(row["first_loss"][0], seen[0], rtol=1e-5)


def test_scaling_tool_exits_nonzero_when_a_mesh_fails(capsys):
    """A fragment capacity below the scene's demand: the warm-up step
    overflows, the row records the error, the tool returns 1."""
    code = SB.main(["--device", "cpu", "--width", str(W), "--height", str(H),
                    "--n", str(N), "--iters", "1", "--fragment_profile",
                    "300"])
    out = capsys.readouterr().out
    assert code == 1
    assert "mesh d1xg1xt1 FAILED" in out and "fragment overflow" in out
    assert '"failed": [{"data": 1, "gauss": 1, "tile": 1}]' in out


def test_tools_need_a_card_or_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = (lambda: SB.main([]),
             lambda: MDR.main(MDR.build_parser().parse_args([])),
             lambda: SM.main([]),
             lambda: MS.main(["--backend", "gloo"]))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# --------------------------------------------------------------------------
# measure_dyn_replication
# --------------------------------------------------------------------------


def test_dyn_replication_matches_jax():
    """The JAX script's store, trainer, `deform_loss`, its gradient and
    `adam_step` (:38-70) at capacity 1,024 on the same parameters: the
    motion coefficients and the net's weights seeded on both sides (the
    script's zero coefficients leave the net without a gradient, and at
    the init's 1e-2 weights every time's activations are near zero, so the
    bias gradients are differences of nearly equal float32 sums). The
    output bias of the heads gets exactly zero gradient (it enters the
    basis at t and at the birth time alike, and inverse motion subtracts
    the two): both sides must leave only rounding noise there."""
    cap = 1024
    n = cap * 3 // 4
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    times = (rng.integers(0, 12, size=n) / 11).astype(np.float32)
    jstore = JG.from_point_cloud(pts, cols, sh_degree=3, capacity=cap,
                                 times=times)
    cfg = jtd.DynTrainerConfig(
        image_width=1920, image_height=1080, sh_degree=3,
        deform_netwidth=128, deform_t_emb_multires=26, num_basis=16,
        inverse_motion=True)
    jdt = jtd.DynTrainer(cfg, jlosses.MultiLoss(
        [jlosses.LossTerm("l1", 1.0, "L1Loss")]), jstore, 5.0,
        jax.random.key(0))
    seeded = np.random.default_rng(3)
    jparams = jdt.params()
    jparams = jparams._replace(
        motion_coeff=jnp.asarray(seeded.normal(
            0, 0.1, jparams.motion_coeff.shape), jnp.float32),
        net={g: {k: jnp.asarray(seeded.normal(0, 0.3, v.shape), jnp.float32)
                 if k.startswith("w") else v for k, v in layer.items()}
             for g, layer in jparams.net.items()})

    def deform_loss(params, t):
        transl, rot_delta = jdt.deformation(params, t,
                                            jdt.state.store.time_ind)
        return jnp.sum(transl * 1e-3) + jnp.sum(rot_delta * 1e-3)

    t_val = 0.37
    jloss, jg = jax.jit(jax.value_and_grad(deform_loss))(
        jparams, jnp.asarray(t_val))
    jnew, jopt = joptim.adam_update(jg, joptim.adam_init(jparams), jparams,
                                    jdt.lr_tree(jnp.asarray(1000.0)))

    dt = MDR.build(cap, "cpu")
    cmp_store(jstore, dt.state.store, "store", pts)
    params = convert.dyn_params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    loss, g = MDR.deform_value_and_grad(dt, params, torch.tensor(t_val))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = flat(g), flat(jg)
    assert sorted(got) == sorted(want)
    largest = max(np.abs(v).max() for v in want.values())
    for k in want:
        if k == ".net.heads.b1":
            for side in (got[k], want[k]):
                assert np.abs(side).max() <= 1e-6 * largest
            continue
        scale = np.abs(want[k]).max() + 1e-10
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=GRAD_TOL, err_msg=k)
    # one Adam step from the JAX gradients on both sides
    new, opt = MDR.adam_step(
        dt, convert.dyn_params_from_numpy(jax.tree.map(np.asarray, jg), "cpu"),
        adam_init(params), params)
    for k, v in flat(jnew).items():
        np.testing.assert_allclose(flat(new)[k], v, rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    assert int(opt.count) == int(jopt.count) == 1
    assert len(tree_leaves(new)) == len(jax.tree.leaves(jnew))


# --------------------------------------------------------------------------
# sort_microbench
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_rows", [0, 10])
def test_sort_inputs_match_jax(n_rows, monkeypatch):
    key, rows = SM.make_inputs(4096, n_rows)
    jkey, jrows = jsm1.make_inputs(4096, n_rows)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    key, rows = SM._key_rows(4, 1024, n_rows)
    jkey, jrows = jsm3._key_rows(4, 1024, n_rows)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    # sort_microbench2.bench draws the same arrays inline (:47-52)
    drawn = []
    monkeypatch.setattr(jsm2, "chained_batched_sort",
                        lambda k, r, *a: drawn.append((k, r)) or 0.0)
    jsm2.bench(4, 1024, n_rows, 1, 1)
    np.testing.assert_array_equal(key.numpy(), np.asarray(drawn[0][0]))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(drawn[0][1]))


def _lax_sorted(key, iota, rows, dimension=0, stable=True, num_keys=1):
    ops = (jnp.asarray(key), jnp.asarray(iota)) + tuple(
        jnp.asarray(r) for r in rows)
    return [np.asarray(x) for x in jax.lax.sort(
        ops, dimension=dimension, num_keys=num_keys, is_stable=stable)]


@pytest.mark.parametrize("variant", [
    dict(), dict(stable=False, num_keys=2)], ids=["stable", "unstable_2keys"])
def test_sort_1d_matches_lax_sort(variant):
    key, rows = SM.make_inputs(4096, 13)
    # ties of the key, so that stability decides the order
    key = key & ~0x3FF
    out_key, perm, out_rows = SM.sort_1d(key, rows, 13, **variant)
    want = _lax_sorted(key.numpy(), np.arange(4096, dtype=np.int32),
                       rows.numpy(), stable=True)
    np.testing.assert_array_equal(out_key.numpy(), want[0])
    np.testing.assert_array_equal(perm.numpy(), want[1])
    np.testing.assert_array_equal(out_rows.numpy(), np.stack(want[2:]))
    if not variant:
        p2, r2 = sort_fragments(key, rows)
        assert torch.equal(perm, p2) and torch.equal(out_rows, r2)


def test_sort_2d_matches_lax_sort():
    key, rows = SM._key_rows(4, 1024, 10)
    key = key & ~0x3FF
    out_key, perm, out_rows = SM.sort_2d(key, rows, 10)
    iota = np.broadcast_to(np.arange(1024, dtype=np.int32), (4, 1024))
    want = _lax_sorted(key.numpy(), iota,
                       list(rows.numpy().transpose(1, 0, 2)), dimension=1)
    np.testing.assert_array_equal(out_key.numpy(), want[0])
    np.testing.assert_array_equal(perm.numpy(), want[1])
    np.testing.assert_array_equal(out_rows.numpy(),
                                  np.stack(want[2:], axis=1))


@pytest.mark.parametrize("n_rows,with_iota", [(10, True), (0, True),
                                              (0, False)])
def test_sort_chain_matches_jax(n_rows, with_iota):
    """Three chained sorts: the JAX script's reduction of the final key
    and rows (`chained_sort`, :38-62) from the port's chain."""
    key, rows = SM.make_inputs(4096, n_rows)
    got_key, got_rows = SM.chain_1d(key, rows, n_rows, 3,
                                    with_iota=with_iota)
    want = jsm1.chained_sort(*jsm1.make_inputs(4096, n_rows), n_rows, 3, True,
                             1, with_iota)
    got = np.asarray(got_key[::65536].numpy()).sum(dtype=np.int32) \
        + got_rows[:, ::65536].numpy().sum()
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


# --------------------------------------------------------------------------
# multihost_smoke
# --------------------------------------------------------------------------


def test_multihost_smoke_two_processes():
    res = MS.launch(2, "gloo", "cpu", timeout_s=WORLD_TIMEOUT)
    assert res["shape"] == {"data": 2, "gauss": 1, "tile": 1}
    assert res["ok"], res["outputs"]
    ref = res["reference"][0]["losses"]
    assert len(ref) == 6 and np.isfinite(ref).all()
    for w in res["workers"]:
        assert w["losses"] == ref
    assert [w["coords"]["data"] for w in res["workers"]] == [0, 1]
    assert res["shared"] == ["dryrun_resume.ckpt"]
