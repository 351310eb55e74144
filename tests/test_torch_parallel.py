"""Multi-device parity of the port with the JAX package on the CPU: the
sharded render (tile, gauss and gauss x tile splits, the render knobs and
the legacy path inside a tile split), the mesh and `shard_interleave`.

The JAX side runs its `shard_map` on k of the 8 virtual CPU devices
(tests/conftest.py) in this process; the port's side runs in a spawned
world of k Gloo ranks (`parallel.dryrun.run_world`, tests/
torch_parallel_ranks.py, which imports no JAX), one world per mesh shape
for all of that shape's cases, each with its own deadline. Tolerances are
the ROADMAP's: image 2e-5, depth 2e-4, gradients by their max 5e-4. Against
the port's own single-process render the planes must be equal: a rank
composites its tiles exactly as the whole grid does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from rodygs_tpu.models import gaussians as JG
from rodygs_tpu.parallel import mesh as jmesh
from rodygs_tpu.parallel import sharded as jsharded
from rodygs_tpu.render.camera import make_camera as jmake_camera
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu_torch.models import gaussians as TG
from rodygs_tpu_torch.parallel import make_mesh
from rodygs_tpu_torch.parallel.dryrun import run_world
from rodygs_tpu_torch.render import rasterize as TR
from rodygs_tpu_torch.render.camera import make_camera as tmake_camera

import torch_parallel_ranks as ranks

IMG_TOL, DEPTH_TOL, GRAD_TOL = 2e-5, 2e-4, 5e-4
# 5 x 3 = 15 tiles: 4 blocks of 4 (the last padded), 3 blocks of 5
W, H = 72, 48
WORLD_TIMEOUT = 240.0


def make_scene(seed=0, n=56, cap=256, width=W, height=H):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5],
                      size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    store = TG.from_point_cloud(pts, cols, sh_degree=1, capacity=cap,
                                device="cpu")
    p = store.params
    opacity = np.where(np.asarray(store.alive)[:, None],
                       rng.normal(0.0, 1.5, (cap, 1)), 0).astype(np.float32)
    return dict(
        xyz=p.xyz.numpy(), shs=TG.get_features(p).numpy(), opacity=opacity,
        scaling=TG.get_scaling(p).numpy(), rotation=p.rotation.numpy(),
        alive=store.alive.numpy(),
        camera=(np.array([1.0, 0, 0, 0], np.float32),
                np.array([0.05, -0.02, 0.0], np.float32), 0.9, 0.7, 0.0),
        W=width, H=height, sh_degree=1,
        gt=rng.uniform(size=(height, width, 3)).astype(np.float32))


def port_single(scene, grads=True, **kw):
    """The port's single-process render and (grads) the gradients of the
    test loss."""
    T = ranks.T
    xyz = T(scene["xyz"]).requires_grad_(grads)
    opac = T(scene["opacity"]).requires_grad_(grads)
    out = TR.render(xyz, T(scene["shs"]), torch.sigmoid(opac[:, 0]),
                    T(scene["scaling"]), T(scene["rotation"]),
                    tmake_camera(*scene["camera"], device="cpu"),
                    scene["sh_degree"], scene["W"], scene["H"],
                    alive=T(scene["alive"]), **kw)
    planes = {k: v.detach().numpy() for k, v in out.items()
              if isinstance(v, torch.Tensor) and v.dim() > 0}
    if not grads:
        return planes, None
    loss = ((out["rendered_image"] - T(scene["gt"])) ** 2).mean()
    g = torch.autograd.grad(loss, [xyz, opac])
    return planes, [x.numpy() for x in g]


def jax_sharded(scene, shape, uses_gauss, **kw):
    """The JAX package's render under shard_map on k virtual devices: the
    planes, radii and the gradients of the (composite-averaged) loss."""
    k = shape["data"] * shape["gauss"] * shape["tile"]
    mesh = jmesh.make_mesh(n_data=shape["data"], n_tile=shape["tile"],
                           n_gauss=shape["gauss"], devices=jax.devices()[:k])
    comp = jsharded.composite_axes(shape["gauss"], shape["tile"])
    gauss = "gauss" if uses_gauss else None
    cam = jmake_camera(*[jnp.asarray(x) for x in scene["camera"]])
    gt = jnp.asarray(scene["gt"])
    rest = [jnp.asarray(scene[k]) for k in ("shs", "scaling", "rotation",
                                            "alive")]
    spec = P("gauss") if uses_gauss else P()

    def inner(xyz, opac, shs, scal, rot, alive):
        out = jrender(xyz, shs, jax.nn.sigmoid(opac[:, 0]), scal, rot, cam,
                      scene["sh_degree"], scene["W"], scene["H"],
                      alive=alive, tile_axis=comp, gauss_axis=gauss, **kw)
        loss = jnp.mean((out["rendered_image"] - gt) ** 2)
        if comp is not None:
            loss = jax.lax.pmean(loss, comp)
        return loss, out["rendered_image"], out["rendered_depth"], out["radii"]

    fn = shard_map(inner, mesh=mesh, in_specs=(spec,) * 6,
                   out_specs=(P(), P(), P(), P()), check_vma=False)
    xyz, opac = jnp.asarray(scene["xyz"]), jnp.asarray(scene["opacity"])
    _, img, depth, radii = jax.jit(lambda a, b: fn(a, b, *rest))(xyz, opac)
    grads = jax.jit(jax.grad(lambda a, b: fn(a, b, *rest)[0],
                             argnums=(0, 1)))(xyz, opac)
    return ({"rendered_image": np.asarray(img),
             "rendered_depth": np.asarray(depth), "radii": np.asarray(radii)},
            [np.asarray(g) for g in grads])


def assert_scaled(a, b, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-10
    np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL,
                               err_msg=name)


def global_grads(results, name="plain"):
    """The global gradients of case `name` from the ranks of data row 0,
    tile column 0 (each holds its gauss block, already summed over the
    tile axis), concatenated in gauss order."""
    blocks = {r["coords"]["gauss"]: r["cases"][name] for r in results
              if r["coords"]["data"] == 0 and r["coords"]["tile"] == 0}
    return [np.concatenate([blocks[g][k] for g in sorted(blocks)])
            for k in ("g_xyz", "g_opacity")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this process (the ranks run on one each):
    the suite runs several worker processes on the same cores, where
    torch's OpenMP barriers wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spawn(jobs):
    """Every job (mesh shape, scene, cases) in one world of as many ranks
    as the shapes (equal) have positions; per job, the ranks' results."""
    k = {s["data"] * s["gauss"] * s["tile"] for s, _, _ in jobs}
    assert len(k) == 1
    out = run_world(ranks.render_cases, k.pop(), (jobs,), backend="gloo",
                    timeout_s=WORLD_TIMEOUT)
    return [[r[i] for r in out] for i in range(len(jobs))]


# --------------------------------------------------------------------------
# four ranks: the tile split (1 x 1 x 4: 15 tiles in 4 blocks, the last
# padded) with every knob, the gauss split (1 x 4 x 1), both (1 x 2 x 2)
# --------------------------------------------------------------------------

TILE4 = {"data": 1, "gauss": 1, "tile": 4}
GAUSS4 = {"data": 1, "gauss": 4, "tile": 1}
GAUSS_TILE = {"data": 1, "gauss": 2, "tile": 2}
KNOB_CASES = [
    ("plain", {}),
    ("gather", {"knobs": {"_FWD_RECORDS": "gather", "_BWD_UNSORT": "gather"}}),
    ("bf16", {"bf16_records": True}),
    ("tight_aabb", {"tight_rect": True}),
    ("tight_rows", {"tight_rect": "rows"}),
    ("loose", {"tight_rect": False}),
    ("bands", {"fragment_profile": "wide", "sort_bands": 3}),
    ("legacy", {"binning_mode": "legacy"}),
]


@pytest.fixture(scope="module")
def scene():
    return make_scene()


@pytest.fixture(scope="module")
def four_ranks(scene):
    plain = [("plain", {}, True, True)]
    return spawn([
        (TILE4, scene, [(name, kw, False, True) for name, kw in KNOB_CASES]),
        (GAUSS4, scene, plain), (GAUSS_TILE, scene, plain)])


@pytest.fixture(scope="module")
def tile4(four_ranks):
    return four_ranks[0]


def _single_kw(kw):
    return {k: v for k, v in kw.items() if k != "knobs"}


def test_tile_split_render_matches_jax_and_single(scene, tile4):
    """The tile-split planes equal the port's single-process render and lie
    within the image / depth bars of the JAX package's tile-split render;
    the gradients within 5e-4 of their max of both."""
    single, g_single = port_single(scene)
    jout, g_jax = jax_sharded(scene, TILE4, False)
    for r in tile4:
        got = r["cases"]["plain"]
        np.testing.assert_array_equal(got["image"], single["rendered_image"])
        np.testing.assert_array_equal(got["depth"], single["rendered_depth"])
        np.testing.assert_allclose(got["image"], jout["rendered_image"],
                                   atol=IMG_TOL)
        np.testing.assert_allclose(got["depth"], jout["rendered_depth"],
                                   atol=DEPTH_TOL)
        np.testing.assert_array_equal(got["radii"], jout["radii"])
        for a, name in ((g_single, "single"), (g_jax, "jax")):
            assert_scaled(a[0], got["g_xyz"], f"xyz vs {name}")
            assert_scaled(a[1], got["g_opacity"], f"opacity vs {name}")
    assert np.abs(g_single[0]).max() > 0


@pytest.mark.parametrize("name,kw", KNOB_CASES[1:],
                         ids=[c[0] for c in KNOB_CASES[1:]])
def test_tile_split_knobs(scene, tile4, name, kw):
    """Every render knob inside the tile split: the gather records and
    unsort, the tight modes, the loose circle rects, sort bands and the
    legacy path equal the single-process render of the same setting; bf16
    lies within its bar of the float32 planes."""
    single, g_single = port_single(scene, **_single_kw(kw))
    for r in tile4:
        got = r["cases"][name]
        np.testing.assert_array_equal(got["image"], single["rendered_image"])
        assert_scaled(g_single[0], got["g_xyz"], name)
        assert_scaled(g_single[1], got["g_opacity"], name)
        if name == "bf16":
            plain = r["cases"]["plain"]["image"]
            assert 0 < np.abs(got["image"] - plain).max() < 1e-2
        if name in ("gather", "bands"):
            np.testing.assert_array_equal(got["image"],
                                          r["cases"]["plain"]["image"])


# --------------------------------------------------------------------------
# three tile blocks: 16 tiles (6, 6 and 4 + 2 padded) against JAX, and
# 1,024 tiles (342, 342 and 340 + 2 padded) against the single render
# --------------------------------------------------------------------------


def test_three_tile_blocks_match_jax_and_single():
    shape = {"data": 1, "gauss": 1, "tile": 3}
    small = make_scene(seed=2, width=64, height=64)
    big = make_scene(seed=3, n=200, cap=512, width=512, height=512)
    assert (big["W"] // 16) * (big["H"] // 16) == 1024
    small_out, big_out = spawn([(shape, small, [("plain", {}, False, True)]),
                                (shape, big, [("plain", {}, False, False)])])
    single, g_single = port_single(small)
    jout, g_jax = jax_sharded(small, shape, False)
    for r in small_out:
        got = r["cases"]["plain"]
        np.testing.assert_array_equal(got["image"], single["rendered_image"])
        np.testing.assert_array_equal(got["alpha"], single["rendered_alpha"])
        np.testing.assert_allclose(got["image"], jout["rendered_image"],
                                   atol=IMG_TOL)
        np.testing.assert_allclose(got["depth"], jout["rendered_depth"],
                                   atol=DEPTH_TOL)
        for ref in (g_single, g_jax):
            assert_scaled(ref[0], got["g_xyz"])
            assert_scaled(ref[1], got["g_opacity"])
    with torch.no_grad():
        single, _ = port_single(big, grads=False)
    for r in big_out:
        got = r["cases"]["plain"]
        np.testing.assert_array_equal(got["image"], single["rendered_image"])
        np.testing.assert_array_equal(got["alpha"], single["rendered_alpha"])
    assert single["rendered_alpha"].max() > 0.5


def test_gauss_split_render_matches_jax(scene, four_ranks):
    """1 x 4 x 1: the records gathered over 4 store blocks give the single
    render's planes and radii; each block gets its own gradients."""
    out = four_ranks[1]
    single, g_single = port_single(scene)
    jout, g_jax = jax_sharded(scene, GAUSS4, True)
    for r in out:
        got = r["cases"]["plain"]
        np.testing.assert_array_equal(got["image"], single["rendered_image"])
        np.testing.assert_array_equal(got["radii"], single["radii"])
        np.testing.assert_array_equal(got["radii"], jout["radii"])
        np.testing.assert_allclose(got["image"], jout["rendered_image"],
                                   atol=IMG_TOL)
    for ref in (g_single, g_jax):
        for a, b, name in zip(ref, global_grads(out), ("xyz", "opacity")):
            assert_scaled(a, b, name)


def test_gauss_tile_split_grads_match_jax(scene, four_ranks):
    """1 x 2 x 2: compositing split over ("gauss", "tile"); the gradients
    reassemble through the record gather's reduce-scatter and the tile
    psum."""
    out = four_ranks[2]
    single, g_single = port_single(scene)
    _, g_jax = jax_sharded(scene, GAUSS_TILE, True)
    for ref in (g_single, g_jax):
        for a, b, name in zip(ref, global_grads(out), ("xyz", "opacity")):
            assert_scaled(a, b, name)
    for r in out:
        np.testing.assert_array_equal(r["cases"]["plain"]["image"],
                                      single["rendered_image"])


# --------------------------------------------------------------------------
# mesh, shard_interleave
# --------------------------------------------------------------------------


def test_make_mesh_single_process():
    """Without a world: the 1 x 1 x 1 mesh (collectives are the identity)
    and the JAX assert's error on a product that does not match."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "gauss": 1, "tile": 1}
    assert mesh.coords == {"data": 0, "gauss": 0, "tile": 0}
    assert mesh.world.size == 1 and mesh.axis(("gauss", "tile")).group is None
    with pytest.raises(ValueError, match="mesh 2x1x1 != 1 processes"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 0x2x2 != 1 processes"):
        make_mesh(n_tile=2, n_gauss=2, device="cpu")


def test_make_mesh_over_a_subset_of_ranks():
    """A mesh over the first ranks of a 4-rank world (the baseline of a
    scaling sweep): positions on ranks 0.. in order, groups of those ranks
    only, None on the others, and every rank still joins the group
    creation; then the whole world on the same ranks. A rank count outside
    the world is refused."""
    out = run_world(ranks.sub_mesh_groups, 4, (), backend="gloo",
                    timeout_s=WORLD_TIMEOUT)
    for rank, r in enumerate(out):
        if rank < 2:
            d2 = r["d2"]
            assert d2["coords"] == {"data": rank, "gauss": 0, "tile": 0}
            assert d2["world_size"] == 2 and d2["sum"] == 1.0
            assert d2["groups"]["data"] == [0, 1]
            assert d2["groups"]["gauss"] == [rank]
        else:
            assert r["d2"] is None
        if rank < 3:
            g3 = r["g3"]
            assert g3["coords"] == {"data": 0, "gauss": rank, "tile": 0}
            assert g3["sum"] == 3.0
            assert g3["groups"]["gauss"] == g3["groups"]["gauss/tile"] == [
                0, 1, 2]
        else:
            assert r["g3"] is None
        t4 = r["t4"]
        assert t4["coords"]["tile"] == rank and t4["world_size"] == 4
        assert t4["groups"]["tile"] == [0, 1, 2, 3] and t4["sum"] == 6.0
    for bad in (0, 2):
        with pytest.raises(ValueError, match="a mesh on"):
            make_mesh(device="cpu", ranks=bad)
    assert make_mesh(device="cpu", ranks=1).shape["data"] == 1


def test_collectives_refuse_other_devices():
    """A collective checks its tensor against the mesh's device type: no
    silent move between the card and the host."""
    from rodygs_tpu_torch.parallel import collectives as C
    from rodygs_tpu_torch.parallel.mesh import Axis

    cuda_axis = Axis(("tile",), 2, 0, None, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cuda mesh got a cpu tensor"):
        C.psum(torch.ones(3), cuda_axis)
    with pytest.raises(ValueError, match="cuda mesh got a cpu tensor"):
        C.all_gather(torch.ones(3), cuda_axis)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_interleave_matches(n_shards):
    rng = np.random.default_rng(n_shards)
    cap, n = 32, 13
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    js = JG.shard_interleave(JG.from_point_cloud(pts, cols, sh_degree=1,
                                                 capacity=cap), n_shards)
    ts = TG.shard_interleave(TG.from_point_cloud(pts, cols, sh_degree=1,
                                                 capacity=cap, device="cpu"),
                             n_shards)
    for name in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    for name in JG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(ts.params, name).numpy(),
                                   np.asarray(getattr(js.params, name)),
                                   rtol=1e-6, atol=1e-7)
    # every block starts with its share of the alive slots
    blocks = ts.alive.numpy().reshape(n_shards, -1).sum(1)
    assert blocks.max() - blocks.min() <= 1
    with pytest.raises(ValueError):
        TG.shard_interleave(ts, 3)
