"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the kernel-check helpers and wrapper guards on the CPU.

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed. On the machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX for the parity suite.)
Tests that need the card take the `cuda_device` fixture and skip without
one; the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rodygs_tpu_torch import kernel_check as KC
from rodygs_tpu_torch import kernels
from rodygs_tpu_torch.evalsuite import lpips as L
from rodygs_tpu_torch.models import gaussians as G
from rodygs_tpu_torch.ops import knn as KNN
from rodygs_tpu_torch.render import compact as C
from rodygs_tpu_torch.render import preprocess as PP
from rodygs_tpu_torch.render import tile_kernel as TK
from rodygs_tpu_torch.render.rasterize import render

SIZE = 64


def scene(n=1500, seed=3, opacity=(0.2, 0.95), device="cpu"):
    return KC.random_scene(n, seed, device, opacity=opacity)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: the CPU suite runs several worker processes on
    the same cores, where torch's OpenMP barriers wait on descheduled
    threads (the plain tile versions here took minutes under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tight", [True, "rows"])
def test_kernel_check_runs_on_plain_versions(tight):
    params, cam = scene()
    s = KC.capture_stages(params, None, cam, 3, SIZE, SIZE, "lean", tight, 1)
    errs = KC.check_stages(s)
    assert errs == {"expand": 0.0, "tile_fwd": 0.0, "tile_bwd": 0.0,
                    "segsum": 0.0}


def test_tile_splits_on_plain_versions():
    """A render composited in 2, 3 and 8 tile blocks at their offsets (the
    ranks of a tile axis) equals the whole grid, and each block's share of
    the four kernels passes against the plain versions."""
    params, cam = scene(n=400)
    s = KC.capture_stages(params, None, cam, 3, SIZE, 48, "lean", True, 1)
    errs = KC.check_tile_splits(s, (2, 3, 8))
    assert max(errs.values()) <= KC.TOL_SPLIT_SCALED
    for i in range(3):
        assert KC.check_tile_block(s, 3, i) == {
            "tile_fwd": 0.0, "tile_bwd": 0.0, "expand": 0.0, "segsum": 0.0}


def _nccl_mesh_rank(rank):
    from rodygs_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(n_data=2)
    except ValueError as e:
        return str(e)
    return None


def test_nccl_refuses_ranks_sharing_a_card(cuda_device):
    """Two NCCL ranks on one card: the mesh raises before any NCCL
    communicator exists, naming the backend variable."""
    from rodygs_tpu_torch.parallel.dryrun import run_world

    if torch.cuda.device_count() > 1:
        pytest.skip("needs ranks that share one card")
    out = run_world(_nccl_mesh_rank, 2, backend="nccl", timeout_s=180.0)
    assert all(m and "RODYGS_DIST_BACKEND" in m for m in out), out


def test_needed_pairs_counts_early_stops():
    # faint splats never saturate a pixel: every pair is evaluated, and
    # most fall below alpha 1/255 away from their centres
    params, cam = scene(opacity=(0.02, 0.05))
    s = KC.capture_stages(params, None, cam, 0, SIZE, SIZE, "lean", True, 1)
    all_pairs = TK.PIX * int(s["cb"].tile_counts.sum())
    contributing, skipped = KC.needed_pairs(s)
    assert contributing + skipped == all_pairs
    assert 0 < contributing < skipped
    # a dense opaque scene stops pixels early
    params, cam = scene(n=4000, opacity=(0.9, 0.99))
    s = KC.capture_stages(params, None, cam, 0, SIZE, SIZE, "lean", True, 1)
    contributing, skipped = KC.needed_pairs(s)
    assert 0 < contributing
    assert contributing + skipped < TK.PIX * int(s["cb"].tile_counts.sum())


def test_check_stages_detects_a_wrong_kernel_output():
    params, cam = scene()
    s = KC.capture_stages(params, None, cam, 3, SIZE, SIZE, "lean", True, 1)
    s["out"] = s["out"].clone()
    s["out"][0, 0, 0] += 1e-3
    with pytest.raises(KC.KernelMismatch, match="tile_fwd"):
        KC.check_stages(s)


@pytest.mark.parametrize("bad,match", [
    (torch.zeros(4, 4), "CUDA tensor"),
])
def test_wrappers_validate_tensors(bad, match):
    with pytest.raises(ValueError, match=match):
        kernels.check_cuda(bad, "x", torch.float32, 2)


def test_import_builds_nothing():
    """The renderer's four kernels, which every render launches, and the
    KNN and the three preprocess entry points, counted beside them."""
    assert set(kernels.KERNELS) == {"expand", "tile_fwd", "tile_bwd",
                                    "segsum"}
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS) | {
        "knn", "preprocess_fwd", "preprocess_bwd", "preprocess_reduce"}
    assert all(name.endswith((".cu", ".cuh"))
               for name in [p.name for p in kernels._CSRC.iterdir()])


def knn_points(n, m, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                         device=device),
            torch.tensor(rng.uniform(-1, 1, (m, 3)), dtype=torch.float32,
                         device=device))


class ReportsCard(torch.Tensor):
    """A CPU tensor that says it lies on a card: `knn`'s choice of path,
    and the wrapper's marshalling, without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case,match", [
    (dict(query=torch.zeros(5, 2)), r"query: expected \[N, 3\]"),
    (dict(targets=torch.zeros(7, 4)), r"targets: expected \[M, 3\]"),
    (dict(valid_mask=torch.ones(6, dtype=torch.bool)), r"valid_mask: expected"),
    (dict(k=5), "the kernel takes k in"),
    ({}, "CUDA tensor"),
])
def test_knn_wrapper_validates_arguments(case, match):
    args = dict(query=torch.zeros(5, 3), targets=torch.zeros(7, 3), k=8,
                valid_mask=torch.ones(7, dtype=torch.bool)) | case
    with pytest.raises(ValueError, match=match):
        KNN.knn_cuda(**args)


@pytest.mark.parametrize("k", [4, 5, 8])
def test_knn_takes_the_plain_path_on_the_cpu(k):
    q, t = knn_points(40, 90, k)
    valid = torch.arange(90) < 70
    kernels.reset_launches()
    d, i = KNN.knn(q, t, k, valid, block_size=16)
    pd, pi = KNN.knn_plain(q, t, k, valid, block_size=16)
    assert torch.equal(d, pd) and torch.equal(i, pi)
    assert kernels.LAUNCHES["knn"] == 0


@pytest.mark.parametrize("k", [3, 5])
def test_knn_without_an_instantiation_raises_on_a_card(k, monkeypatch):
    """A card's tensors always take the kernel: a k it has no
    instantiation for raises, and nothing launches or falls back."""
    q, t = (x.as_subclass(ReportsCard) for x in knn_points(30, 50, k))
    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    monkeypatch.setattr(KNN, "knn_plain", lambda *a: pytest.fail("plain"))
    with pytest.raises(ValueError, match="the kernel takes k in"):
        KNN.knn(q, t, k)


@pytest.mark.parametrize("k,masked", [(4, False), (8, True)])
def test_knn_with_an_instantiation_makes_one_launch(k, masked, monkeypatch):
    """One launch of `knn` with the kernel's C arguments, and outputs of
    the contract's shapes and types."""
    q, t = (x.as_subclass(ReportsCard) for x in knn_points(30, 50, k))
    valid = (torch.arange(50) < 40).as_subclass(ReportsCard) if masked else None
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    d, i = KNN.knn(q, t, k, valid)
    (name, q_, n, t_, m, valid_, k_, d_, i_), = calls
    assert (name, n, m, k_) == ("knn", 30, 50, k)
    assert q_ is q and t_ is t and valid_ is valid and d_ is d and i_ is i
    assert d.shape == i.shape == (30, k)
    assert (d.dtype, i.dtype) == (torch.float32, torch.int32)


def test_check_preprocess_runs_on_plain_versions():
    assert KC.check_preprocess(2000, 900, 3, "cpu", width=128,
                               height=96) == pytest.approx(dict(
        fwd_err=0.0, fwd_bits=True, grad_err=0.0, grad_bits=True,
        visible=KC.check_preprocess(2000, 900, 0, "cpu", width=128,
                                    height=96)["visible"]))


def _card_preprocess(deg, pose_grad, monkeypatch, calls):
    """preprocess on tensors that say they lie on a card, `launch`
    recorded and the plain versions ruled out."""
    ins, alive, cam = KC.preprocess_scene(300, 250, 4, "cpu")
    card = lambda x: x.as_subclass(ReportsCard)
    x = {k: card(v) for k, v in ins.items()}
    x["means3d"].requires_grad_(True)
    cam = cam._replace(q_c2w=card(cam.q_c2w).requires_grad_(pose_grad),
                       t_c2w=card(cam.t_c2w), fovx=card(cam.fovx),
                       fovy=card(cam.fovy))
    monkeypatch.setattr(kernels, "launch", lambda *a: calls.append(a))
    for name in ("_project_plain", "preprocess_backward_plain"):
        monkeypatch.setattr(PP, name, lambda *a: pytest.fail("plain"))
    return PP.preprocess(x["means3d"], x["scales"], x["quats"],
                         x["opacities"], x["shs"], deg, cam, 64, 48,
                         alive=card(alive))


@pytest.mark.parametrize("pose_grad", [False, True])
def test_preprocess_on_a_card_launches_the_kernels(pose_grad, monkeypatch):
    """On a card's tensors the forward is one launch and the backward one,
    plus the camera reduction when the pose takes a gradient; the plain
    versions are never reached."""
    calls = []
    out = _card_preprocess(2, pose_grad, monkeypatch, calls)
    assert [c[0] for c in calls] == ["preprocess_fwd"]
    (_, means, *_rest), = calls
    assert means.shape == (300, 3) and _rest[3:6] == [300, 16, 2]
    (out.mean2d.sum() + out.depth.sum()).backward()
    names = [c[0] for c in calls]
    assert names == ["preprocess_fwd", "preprocess_bwd"] + (
        ["preprocess_reduce"] if pose_grad else [])
    bwd = calls[1]
    assert bwd[5:8] == (300, 16, 2)
    assert (bwd[-1] is not None) == pose_grad      # the camera partials


def test_preprocess_on_a_card_raises_for_an_sh_degree_without_kernel(
        monkeypatch):
    with pytest.raises(ValueError, match="the kernel takes SH degrees"):
        _card_preprocess(4, False, monkeypatch, [])


BATCH_EDGE_COUNTS = [0, 32, 33, 64, 65, 1, 2100, 0, 31, 129]


@pytest.mark.parametrize("offset", [0, 5])
def test_synthetic_tiles_dead_normals_bit_equal(offset):
    """include_normal=False is the 8-channel walk on zero normal rows, on
    hand-made ranges of every batch-edge length."""
    counts = BATCH_EDGE_COUNTS[:6] + [300]
    rec, starts, cnts, off = KC.synthetic_tiles(counts, 4, "cpu", 3, offset)
    assert int(off) == offset and int(cnts.sum()) + 37 == rec.shape[1]
    out5 = TK.rasterize_fwd_impl(rec, starts, cnts, off, 3, False)
    out8 = TK.rasterize_fwd_impl(rec, starts, cnts, off, 3, True)
    assert torch.equal(out5, out8) and float(out5[:, 7].max()) > 0.5
    gout = torch.tensor(np.random.default_rng(0).normal(
        size=out5.shape).astype(np.float32))
    d5 = TK.rasterize_bwd_impl(rec, starts, cnts, off, out5, gout, 3, False)
    d8 = TK.rasterize_bwd_impl(rec, starts, cnts, off, out5, gout, 3, True)
    live = [r for r in range(16) if r not in (10, 11, 12)]
    assert torch.equal(d5[live], d8[live]) and not d5[10:13].any()
    assert float(d8[10:13].abs().max()) > 0   # the 8-channel walk forms them
    assert not d5[:, int(cnts.sum()):].any()  # unused tail columns stay 0


def _brute_force_warp_pairs(s, shape):
    """walk_stats' warp-pair counts by a per-pixel Python walk."""
    cb, tx = s["cb"], s["tx"]
    rec = s["records"].numpy().astype(np.float32)
    warp_of = TK.warp_of_pixel(shape).numpy()
    log_eps = np.float32(TK.LOG_T_EPS)
    n = dict.fromkeys(("block_walk", "evaluates", "passes", "contributes"), 0)
    for t in range(cb.tile_starts.shape[0]):
        x0, y0 = (t % tx) * TK.TILE, (t // tx) * TK.TILE
        start, count = int(cb.tile_starts[t]), int(cb.tile_counts[t])
        log_t = np.zeros(TK.PIX, np.float32)
        done = np.zeros(TK.PIX, bool)
        px = (x0 + np.arange(TK.PIX) % TK.TILE).astype(np.float32)
        py = (y0 + np.arange(TK.PIX) // TK.TILE).astype(np.float32)
        for j in range(start, start + count):
            mx, my, ca, cb_, cc, op = rec[:6, j]
            dx, dy = px - mx, py - my
            sigma = np.float32(0.5) * (ca * dx * dx + cc * dy * dy) + cb_ * dx * dy
            alpha = np.minimum(np.float32(TK.ALPHA_MAX), op * np.exp(-sigma))
            passes = ~done & (sigma >= 0) & (alpha >= np.float32(TK.ALPHA_EPS))
            incl = log_t + np.log1p(-np.where(passes, alpha, np.float32(0)))
            contributes = passes & (incl >= log_eps)
            n["block_walk"] += TK.NUM_WARPS * bool((~done).any())
            for name, m in (("evaluates", ~done), ("passes", passes),
                            ("contributes", contributes)):
                n[name] += len(set(warp_of[m]))
            log_t = np.where(contributes, incl, log_t)
            done |= passes & ~contributes
    return n


@pytest.mark.parametrize("shape", ["block", "strip"])
def test_walk_stats_match_brute_force(shape):
    params, cam = scene(n=250, opacity=(0.5, 0.99))
    s = KC.capture_stages(params, None, cam, 0, 48, 32, "lean", True, 1)
    stats = KC.walk_stats(s)
    got = stats["warp_pairs"][shape]
    want = _brute_force_warp_pairs(s, shape)
    # float32 numpy and torch may round exp/log1p apart on a borderline pair
    for name, v in want.items():
        assert abs(got[name] - v) <= max(2, v // 500), (name, got[name], v)
    assert got["contributes"] <= got["passes"] <= got["kept"] <= got["evaluates"]
    assert got["evaluates"] <= got["block_walk"]
    assert 0 < got["kept"] < got["evaluates"]
    tc = s["cb"].tile_counts.double()
    assert stats["tile_counts"]["max"] == float(tc.max())
    assert stats["tile_counts"]["mean"] == pytest.approx(float(tc.mean()))
    assert stats["tile_walked"]["max"] <= stats["tile_counts"]["max"]
    contributing, skipped = KC.needed_pairs(s)
    assert got["contributes"] <= contributing
    # the cull drops no contributing pair, and a kept pair has 32 lanes
    assert contributing < got["kept_lanes"] < contributing + skipped
    assert got["kept"] <= got["kept_lanes"] <= 32 * got["kept"]


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       where=st.sampled_from(["inside", "edge", "near", "far"]),
       log_axes=st.tuples(st.floats(-1.5, 3.5), st.floats(-1.5, 3.5)),
       op_ratio=st.one_of(st.floats(0.9, 1.1), st.floats(1.0, 250.0)),
       shape=st.sampled_from(["block", "strip"]))
def test_warp_cull_is_conservative(seed, where, log_axes, op_ratio, shape):
    """Wherever the cull says skip, no pixel of the warp's rectangle passes
    the compositor's test (sigma >= 0 and alpha >= 1/255, `_chunk_alpha`'s
    arithmetic): conics from needles to blobs, opacities at and above
    1/255, means inside, on the edge of, near and far from the rectangle."""
    rng = np.random.default_rng(seed)
    k, tx = 64, 2
    lo, hi = {"inside": (0, 15), "edge": (-0.5, 15.5), "near": (-6, 22),
              "far": (-60, 80)}[where]
    rec = np.zeros((6, 1, k), np.float32)
    rec[0] = 16 + rng.uniform(lo, hi, k)            # tile 1 of a 2-wide grid
    rec[1] = rng.uniform(lo, hi, k)
    if where == "edge":                              # exactly on pixel lines
        rec[0] = np.round(rec[0])
    s1, s2 = (np.exp(a + rng.uniform(-0.3, 0.3, k)) for a in log_axes)
    th = rng.uniform(0, np.pi, k)
    c, s = np.cos(th), np.sin(th)
    rec[2] = c * c / s1**2 + s * s / s2**2
    rec[3] = c * s * (1 / s1**2 - 1 / s2**2)
    rec[4] = s * s / s1**2 + c * c / s2**2
    rec[5] = np.minimum(op_ratio * rng.uniform(0.95, 1.05, k) / 255.0, 1.0)
    rec = torch.tensor(rec)
    off = torch.tensor([1], dtype=torch.int32)
    keep = TK.warp_cull_keep_plain(rec, off, tx, shape)          # [1, 8, K]
    px, py = TK._pixel_coords(off, 1, tx)
    alpha = TK._chunk_alpha(rec, px, py, torch.ones((1, k), dtype=bool))[4]
    passes = KC._any_per_warp(alpha > 0, shape)
    assert not (passes & ~keep).any()


# Slot counts per gaussian that the fragment kernels' parts fear, as
# (counts, chunks of 512 slots, f_kept).
_MIXED = [1] * 40 + [3000] + [2] * 30 + [1, 7, 1, 90, 1] * 20
RANGE_CASES = {
    "one_long_segment": (_MIXED, 11, sum(_MIXED)),
    "runs_of_one_slot": ([1] * 1500, 3, 1500),
    # the 101st gaussian's last slot is slot 511, the 102nd starts a chunk
    "segment_ends_on_chunk_edge": ([1] * 100 + [412] + [3] * 170, 2, 1022),
    "f_kept_zero": (_MIXED, 11, 0),
    "f_kept_is_capacity": ([5] * 200 + [24], 2, 1024),
    "f_kept_inside_segment": (_MIXED, 11, 40 + 1700),
    # 3 chunks hold 1,536 slots: the gaussians from slot 1,100 on are
    # dropped, some with offsets past the capacity
    "dropped_past_f_kept": ([1] * 100 + [500] * 2 + [700] + [2] * 300, 3,
                            1100),
}


def _brute_force_segsum(table, f_kept, d):
    """Per-gaussian loop over the clamped slot ranges, summed in float64."""
    off = table[C.ROW_OFF].numpy().astype(np.int64)
    end = min(int(f_kept), d.shape[1])
    lo = np.minimum(off, end)
    hi = np.minimum(np.append(off[1:], end), end)
    out = np.zeros((d.shape[0], off.shape[0]), np.float64)
    for g in np.nonzero(hi > lo)[0]:
        out[:, g] = d[:, lo[g]:hi[g]].numpy().astype(np.float64).sum(axis=1)
    return out


def _assert_segsum_plain(counts, chunks, f_kept, seed):
    table, _, fk, d, _ = KC.synthetic_ranges(counts, chunks, f_kept, seed,
                                             "cpu")
    got = C.segment_sum_rows_plain(d, table, fk).numpy()
    want = _brute_force_segsum(table, fk, d)
    assert np.isfinite(got).all()      # the NaN at and past f_kept is not read
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=KC.TOL_SEGSUM_SCALED * max(
                                   1e-30, np.abs(want).max()))
    assert (got[:, len(counts):] == 0).all()        # pad columns


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_segsum_plain_matches_brute_force(case):
    _assert_segsum_plain(*RANGE_CASES[case], seed=4)


@st.composite
def slot_ranges(draw):
    """(counts, chunks, f_kept): runs of one-slot gaussians, segments of up
    to 4,000 slots and segments that end exactly on a chunk edge, a
    capacity that holds them all or drops the last ones, and f_kept at 0,
    at the capacity, on a range boundary or inside a range."""
    counts = []
    for kind in draw(st.lists(st.sampled_from(["ones", "long", "align"]),
                              min_size=1, max_size=6)):
        if kind == "ones":
            counts += [1] * draw(st.integers(1, 700))
        elif kind == "long":
            counts.append(draw(st.integers(2, 4000)))
        else:
            counts.append(C.FCHUNK - sum(counts) % C.FCHUNK)
    total = sum(counts)
    chunks = max(1, -(-total // C.FCHUNK) + draw(st.integers(-2, 2)))
    cap = chunks * C.FCHUNK
    ends = [e for e in np.cumsum(counts).tolist() if e <= cap]
    f_kept = draw(st.sampled_from(["zero", "full", "boundary", "inside"]))
    f_kept = {"zero": 0, "full": min(total, cap) if total <= cap else cap,
              "boundary": ends[draw(st.integers(0, len(ends) - 1))]
              if ends else 0,
              "inside": draw(st.integers(0, min(total, cap)))}[f_kept]
    return counts, chunks, f_kept


@settings(max_examples=60, deadline=None)
@given(case=slot_ranges(), seed=st.integers(0, 2**31 - 1))
def test_segsum_plain_matches_brute_force_on_drawn_ranges(case, seed):
    _assert_segsum_plain(*case, seed=seed)


@pytest.mark.parametrize("rows_mode", [False, True])
def test_synthetic_ranges_follow_the_binning_layout(rows_mode):
    counts, chunks, f_kept = RANGE_CASES["dropped_past_f_kept"]
    table, bases, fk, d, db = KC.synthetic_ranges(counts, chunks, f_kept, 1,
                                                  "cpu", rows_mode=rows_mode)
    assert table.shape == (40 if rows_mode else 24,
                           C.padded_width(len(counts)))
    assert int(fk) == f_kept and d.shape == (10, chunks * C.FCHUNK)
    off = table[C.ROW_OFF]
    assert (off[1:] >= off[:-1]).all() and float(off[len(counts)]) >= 2e7
    assert (bases % 128 == 0).all() and int(bases.max()) + C.WIN <= off.numel()
    # every chunk's first slot is owned inside its window
    owner = torch.searchsorted(off, torch.arange(chunks) * 512.0, right=True) - 1
    assert ((owner >= bases) & (owner < bases + C.WIN)).all()
    assert torch.isnan(d[:, f_kept:]).all() and not torch.isnan(d[:, :f_kept]).any()
    key, rec = C.expand_fragments(table, bases, fk, 8, db, 10)
    assert (key[f_kept:] == C.INT32_MAX).all() and (key[:f_kept] != C.INT32_MAX).any()
    KC.check_fragment_kernels(table, bases, fk, 8, db, d)


def test_slot_stats_counts_ranges():
    counts = [1] * 100 + [412] + [600] + [40] + [1] * 10
    table, bases, fk, d, _ = KC.synthetic_ranges(counts, 3, 1152, 1, "cpu")
    st_ = KC.slot_stats({"cb": KC.C.CompactBinning(
        aux_rows=None, bases=bases, tile_starts=None, tile_counts=None,
        f_kept=fk, num_fragments=None, dropped=None, overflow=None),
        "table": table})
    # filled: the 100 ones, the 412, the 600 and the 40 (1,152 slots)
    assert st_["f_kept"] == 1152 and st_["capacity"] == 1536
    assert st_["owning_columns"] == 103 and st_["filled_chunks"] == 3
    assert st_["slots_per_gaussian"]["max"] == 600
    assert st_["share_over_32"] == pytest.approx((412 + 600 + 40) / 1152)
    assert st_["share_over_512"] == pytest.approx(600 / 1152)
    assert st_["cross_chunk"] == 1      # the 600 runs from slot 512 to 1,111


def _render_and_grads(params, cam, size=SIZE):
    leaves = [x.detach().clone().requires_grad_(True) for x in params]
    p = type(params)(*leaves)
    out = render(p.xyz, G.get_features(p), G.get_opacity(p), G.get_scaling(p),
                 p.rotation, cam, 3, size, size)
    (out["rendered_image"].square().mean()
     + out["rendered_depth"].mean()).backward()
    return [out["rendered_image"].detach(), out["rendered_depth"].detach()
            ] + [x.grad for x in leaves]


def _assert_poison_changes_nothing(device, size):
    params, cam = scene(device=device)
    clean = _render_and_grads(params, cam, size)
    seen = []
    real = C.expand_fragments
    with KC.poisoned_expand():
        assert C.expand_fragments is not real
        poisoned_fn = C.expand_fragments

        def spy(*a, **k):
            key, rec = poisoned_fn(*a, **k)
            seen.append(int(torch.isnan(rec).sum()))
            return key, rec

        C.expand_fragments = spy
        try:
            poisoned = _render_and_grads(params, cam, size)
        finally:
            C.expand_fragments = poisoned_fn
    assert C.expand_fragments is real
    assert seen and seen[0] > 0        # the records did carry NaN
    for a, b in zip(clean, poisoned):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def test_poisoned_expand_keeps_render_and_gradient_bits():
    """NaN in every record expand may leave unwritten (slots at or past
    f_kept) changes no bit of the render or of its gradients."""
    _assert_poison_changes_nothing("cpu", SIZE)


@pytest.mark.parametrize("n_rows", [1, 12, 16])
def test_expand_takes_only_the_two_row_counts(n_rows):
    counts, chunks, f_kept = RANGE_CASES["runs_of_one_slot"]
    table, bases, fk, _, db = KC.synthetic_ranges(counts, chunks, f_kept, 1,
                                                  "cpu")
    with pytest.raises(ValueError, match="record rows"):
        C.expand_fragments(table, bases, fk, 8, db, n_rows)


@pytest.mark.parametrize("bands,tight", [(2, True), (3, "rows")])
def test_check_bands_runs_on_plain_versions(bands, tight):
    params, cam = scene()
    errs, cb = KC.check_bands(params, None, cam, 3, SIZE, SIZE, "wide", tight,
                              bands)
    assert errs == dict.fromkeys(("expand", "segsum", "tile_fwd", "tile_bwd"),
                                 0.0)
    assert cb.f_kept.shape == (bands,) and (cb.f_kept > 0).all()


def _banded_renders(device, bands_list, size=SIZE, n=1500):
    """Image and gradients (means3d, opacity, q) of one seeded view at each
    band count."""
    params, cam = scene(n=n, device=device)
    out = {}
    for bands in bands_list:
        xyz = params.xyz.clone().requires_grad_(True)
        op = params.opacity.clone().requires_grad_(True)
        q = cam.q_c2w.clone().requires_grad_(True)
        p = params._replace(xyz=xyz, opacity=op)
        o = render(p.xyz, G.get_features(p), G.get_opacity(p),
                   G.get_scaling(p), p.rotation, cam._replace(q_c2w=q), 3,
                   size, size, fragment_profile="wide", sort_bands=bands)
        (o["rendered_image"].square().mean()
         + o["rendered_depth"].mean()).backward()
        out[bands] = (o["rendered_image"].detach(), [xyz.grad, op.grad, q.grad])
    return out


def _assert_bands_agree(out):
    img1, g1 = out[1]
    for bands, (img, g) in out.items():
        assert torch.equal(img, img1), bands
        for a, b in zip(g1, g):
            torch.testing.assert_close(b / a.abs().max(), a / a.abs().max(),
                                       atol=KC.TOL_BWD_SCALED, rtol=0)


def test_banded_render_keeps_image_bits():
    _assert_bands_agree(_banded_renders("cpu", (1, 2, 4)))


def test_random_lpips_weights_load(tmp_path):
    L.write_random_weights(tmp_path / "w.npz")
    for net, n_convs in (("alex", 5), ("vgg", 13)):
        params = L.load_params(net, str(tmp_path / "w.npz"), "cpu")
        assert sum(k.startswith("conv") for k in params) == 2 * n_convs
        img = torch.rand((32, 32, 3))
        assert float(L.lpips_forward(net, params, img, img)) == 0.0


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tight", [True, "rows"])
def test_cuda_kernels_match_plain(cuda_device, tight):
    params, cam = scene(device=cuda_device)
    kernels.reset_launches()
    s = KC.capture_stages(params, None, cam, 3, 128, 128, "lean", tight, 1)
    KC.check_stages(s)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] >= 1 for k in kernels.KERNELS)


def test_cuda_tile_kernels_needles_and_blobs(cuda_device):
    """Opacities on both sides of 1/255 and conics that cut tile corners:
    the cull's margin; both include_normal settings."""
    params, cam = KC.random_scene(5000, 3, cuda_device, log_scale=(-6.0, -1.0),
                                  opacity=(0.004, 0.99))
    for include_normal in (False, True):
        s = KC.capture_stages(params, None, cam, 3, 128, 128, "lean", True, 1,
                              include_normal=include_normal)
        KC.check_stages(s)


@pytest.mark.parametrize("include_normal", [False, True])
def test_cuda_tile_kernels_batch_edges(cuda_device, include_normal):
    """Tiles of 0 fragments, one batch, one more than a batch, over 2,000;
    the backward twice gives the same bits (inside check_tiles)."""
    rec, starts, cnts, off = KC.synthetic_tiles(BATCH_EDGE_COUNTS, 4,
                                                cuda_device, 4)
    if include_normal:
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        rec[10:14] = torch.rand((4, rec.shape[1]), generator=gen,
                                device=cuda_device)
    KC.check_tiles(rec, starts, cnts, off, 4, include_normal)


def test_cuda_tile_kernels_tile_id_offset(cuda_device):
    """The second half of the tile grid rendered alone with offset T/2
    gives the second half of the whole render and of its gradient."""
    params, cam = scene(device=cuda_device)
    s = KC.capture_stages(params, None, cam, 3, 128, 128, "lean", True, 1)
    cb, half = s["cb"], s["cb"].tile_starts.shape[0] // 2
    off = torch.tensor([half], dtype=torch.int32, device=cuda_device)
    args = (s["records"], cb.tile_starts[half:].contiguous(),
            cb.tile_counts[half:].contiguous(), off)
    KC.check_tiles(*args, s["tx"], False, gout=s["gout"][half:].contiguous())
    out = TK.rasterize_fwd_impl(*args, s["tx"], False)
    assert torch.equal(out, s["out"][half:])
    d_rec = TK.rasterize_bwd_impl(*args, out, s["gout"][half:].contiguous(),
                                  s["tx"], False)
    whole = TK.rasterize_bwd_impl(s["records"], cb.tile_starts, cb.tile_counts,
                                  s["off"], s["out"], s["gout"], s["tx"], False)
    first = int(cb.tile_starts[half])
    assert torch.equal(d_rec[:, first:], whole[:, first:])
    assert not d_rec[:, :first].any()


@pytest.mark.parametrize("rows_mode", [False, True])
@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_cuda_fragment_kernels_on_feared_ranges(cuda_device, case, rows_mode):
    """expand (keys everywhere, records on valid slots) and segsum (1e-5 of
    the maximum, twice for equal bits) against their plain versions; the
    gradient rows are NaN at and past f_kept."""
    counts, chunks, f_kept = RANGE_CASES[case]
    for n_rows in (C.N_CORE_ROWS, C.NUM_REC_ROWS):
        table, bases, fk, d, db = KC.synthetic_ranges(
            counts, chunks, f_kept, 4, cuda_device, rows_mode=rows_mode,
            n_rows=n_rows)
        kernels.reset_launches()
        KC.check_fragment_kernels(table, bases, fk, 8, db, d)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["expand"] == 1
        assert kernels.LAUNCHES["segsum"] == 2


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(case=slot_ranges(), seed=st.integers(0, 2**31 - 1),
       rows_mode=st.booleans())
def test_cuda_fragment_kernels_on_drawn_ranges(cuda_device, case, seed,
                                               rows_mode):
    table, bases, fk, d, db = KC.synthetic_ranges(*case, seed, cuda_device,
                                                  rows_mode=rows_mode)
    KC.check_fragment_kernels(table, bases, fk, 8, db, d)
    torch.cuda.synchronize()


def test_cuda_expand_leaves_empty_slots_unwritten(cuda_device):
    """Keys are INT32_MAX from f_kept on and the records there keep what
    the buffer held; below f_kept every record is written."""
    counts, chunks, f_kept = RANGE_CASES["f_kept_inside_segment"]
    table, bases, fk, _, db = KC.synthetic_ranges(counts, chunks, f_kept, 4,
                                                  cuda_device)
    rec = torch.full((10, chunks * C.FCHUNK), float("nan"), device=cuda_device)
    key, out = C.expand_fragments(table, bases, fk, 8, db, 10, rec_out=rec)
    assert out is rec
    assert torch.isnan(rec[:, f_kept:]).all()
    assert not torch.isnan(rec[:, :f_kept]).any()
    assert (key[f_kept:] == C.INT32_MAX).all()


def test_cuda_poisoned_expand_keeps_render_and_gradient_bits(cuda_device):
    _assert_poison_changes_nothing(cuda_device, 128)


def test_cuda_segsum_rejects_other_row_counts(cuda_device):
    table, bases, fk, d, _ = KC.synthetic_ranges([1] * 600, 2, 600, 1,
                                                 cuda_device)
    with pytest.raises(ValueError, match="10 or 13 rows"):
        C.segment_sum_rows(d[:7].contiguous(), table, bases, fk)


def test_cuda_wrappers_reject_wrong_dtype(cuda_device):
    table = torch.zeros((24, 1280), device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        C.expand_fragments(table, torch.zeros(2, device=cuda_device),
                           torch.zeros((), dtype=torch.int32,
                                       device=cuda_device), 4, 23)


def test_cuda_render_matches_cpu(cuda_device):
    out = {}
    for dev in ("cpu", cuda_device):
        params, cam = scene(device=dev)
        q = cam.q_c2w.clone().requires_grad_(True)
        cam = cam._replace(q_c2w=q)
        o = render(params.xyz, G.get_features(params), G.get_opacity(params),
                   G.get_scaling(params), params.rotation, cam, 3, 128, 128)
        o["rendered_image"].square().mean().backward()
        out[str(dev)] = (o["rendered_image"].detach().cpu(), q.grad.cpu())
    (img_c, g_c), (img_g, g_g) = out.values()
    torch.testing.assert_close(img_g, img_c, atol=1e-4, rtol=0)
    torch.testing.assert_close(g_g / g_c.abs().max(), g_c / g_c.abs().max(),
                               atol=KC.TOL_BWD_SCALED, rtol=0)


@pytest.mark.parametrize("bands,tight", [(2, True), (4, "rows")])
def test_cuda_banded_fragment_kernels_match_plain(cuda_device, bands, tight):
    """expand and segsum on every band: keys equal in every slot, segsum
    within its bar and the same bits twice; the tile kernels on the bands'
    concatenated records (inside check_bands)."""
    params, cam = KC.random_scene(20000, 4, cuda_device)
    kernels.reset_launches()
    errs, cb = KC.check_bands(params, None, cam, 3, 256, 256, "huge", tight,
                              bands)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expand"] >= bands
    assert kernels.LAUNCHES["segsum"] >= 2 * bands
    assert (cb.f_kept > 0).all()


def test_cuda_banded_render_keeps_image_bits(cuda_device):
    kernels.reset_launches()
    _assert_bands_agree(_banded_renders(cuda_device, (1, 2, 4), size=256,
                                        n=20000))
    assert kernels.LAUNCHES["expand"] == 1 + 2 + 4
    assert kernels.LAUNCHES["segsum"] == 1 + 2 + 4


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_cuda_lpips_matches_cpu(cuda_device, net, tmp_path):
    """cuDNN in full fp32 (no TF32) against the CPU's convolutions."""
    L.write_random_weights(tmp_path / "w.npz", seed=6)
    rng = np.random.default_rng(6)
    a = rng.uniform(size=(96, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    card = float(L.lpips_fn(net, str(tmp_path / "w.npz"), cuda_device)(a, b))
    cpu = float(L.lpips_fn(net, str(tmp_path / "w.npz"), "cpu")(a, b))
    assert abs(card - cpu) <= 1e-4 * abs(cpu), (card, cpu)


@pytest.fixture
def fp32_products(monkeypatch):
    """The plain KNN's product in full FP32, as the kernel computes it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def knn_both(q, t, k, valid=None):
    """(kernel, plain) results on the card; the kernel launched once."""
    kernels.reset_launches()
    got = KNN.knn(q, t, k, valid)
    assert kernels.LAUNCHES["knn"] == 1
    return got, KNN.knn_plain(q, t, k, valid)


@pytest.mark.parametrize("n,m,k,masked,same", [
    (1000, 1537, 4, False, False),
    (1000, 1537, 8, True, False),
    (777, 777, 8, False, True),
    (777, 777, 4, True, True),
    (257, 5000, 8, True, True),
])
def test_cuda_knn_matches_plain(cuda_device, fp32_products, n, m, k, masked,
                                same):
    """Tie-free random points, N and M no multiple of the kernel's tiles:
    indices equal, distances at rtol 1e-5 (atol 1e-6 for the self-match,
    whose distance is the rounding of |q|^2 ~ 1 in either form). With the
    queries among the targets each valid query's nearest is itself."""
    q, t = knn_points(n, m, n + m + k, cuda_device)
    if same:
        q = t[:n].contiguous()
    valid = None
    if masked:
        gen = torch.Generator(device=cuda_device).manual_seed(k)
        valid = torch.rand(m, generator=gen, device=cuda_device) < 0.7
    (d, i), (pd, pi) = knn_both(q, t, k, valid)
    assert torch.equal(i, pi)
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=1e-6)
    if same:
        own = torch.arange(n, device=cuda_device, dtype=torch.int32)
        mine = own if valid is None else own[valid[:n]]
        rows = slice(None) if valid is None else valid[:n]
        assert torch.equal(i[rows, 0], mine)


@pytest.mark.parametrize("m,n_valid,k", [(600, 5, 8), (3, 3, 4), (0, 0, 8)])
def test_cuda_knn_fewer_valid_targets_than_k(cuda_device, fp32_products, m,
                                             n_valid, k):
    """The slots no valid target fills read +inf and -1; the filled ones
    are the plain version's."""
    q, t = knn_points(300, m, m + k, cuda_device)
    valid = torch.arange(m, device=cuda_device) >= m - n_valid
    (d, i), (pd, pi) = knn_both(q, t, k, valid)
    assert torch.equal(i, pi)
    assert torch.isinf(d[:, n_valid:]).all() and (i[:, n_valid:] == -1).all()
    assert (i[:, :n_valid] >= m - n_valid).all()
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=0.0)


def test_cuda_knn_exact_ties(cuda_device, fp32_products):
    """Every point three times over, shuffled: equal distances everywhere.
    Each returned index's distance is the distance reported for it, the
    sorted rows equal the plain version's, and of equal distances the lower
    index comes first."""
    rng = np.random.default_rng(7)
    base = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    pts = torch.tensor(np.repeat(base, 3, axis=0)[rng.permutation(600)],
                       device=cuda_device)
    (d, i), (pd, pi) = knn_both(pts, pts, 8)
    exact = ((pts[:, None, :].double() - pts[i.long()].double()) ** 2).sum(-1)
    torch.testing.assert_close(d.double(), exact, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=1e-6)
    tied = d[:, 1:] == d[:, :-1]
    assert tied.any()
    assert (i[:, 1:][tied] > i[:, :-1][tied]).all()


def test_cuda_knn_at_the_cell_shape(cuda_device, fp32_products):
    """The rigidity sample of the benchmark's cell: 131,072 x 131,072, K 8,
    the last 11,072 slots dead (120,000 alive). At most 0.1% of the rows may
    hold another neighbour set than the plain version's, and in each of
    them the K-th distances agree to 1e-5 relative: a near-tie of the 8th
    and 9th."""
    n, alive = 131072, 120000
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    pts = torch.randn((n, 3), generator=gen, device=cuda_device)
    valid = torch.arange(n, device=cuda_device) < alive
    (d, i), (pd, pi) = knn_both(pts, pts, 8, valid)
    differ = (torch.sort(i, dim=1).values
              != torch.sort(pi, dim=1).values).any(dim=1)
    assert int(differ.sum()) <= n // 1000, int(differ.sum())
    torch.testing.assert_close(d[differ, -1], pd[differ, -1], rtol=1e-5,
                               atol=0.0)
    same = ~differ
    torch.testing.assert_close(d[same], pd[same], rtol=1e-5, atol=1e-6)


def test_cuda_knn_without_an_instantiation_raises(cuda_device):
    """On the card a k the kernel has no instantiation for raises before
    any launch; no plain path stands in for it."""
    q, t = knn_points(100, 300, 5, cuda_device)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="the kernel takes k in"):
        KNN.knn(q, t, 5)
    assert kernels.LAUNCHES["knn"] == 0


@pytest.mark.parametrize("n,n_alive,cam_grad", [(262144, 120000, True),
                                                (524288, 240000, False)])
@pytest.mark.parametrize("deg", [0, 3])
def test_cuda_preprocess_matches_plain(cuda_device, n, n_alive, cam_grad,
                                       deg):
    """The cell's two shapes (the static step's store with the pose
    gradient, the dynamic step's concatenation without): radius,
    visibility and the compact binning equal to the plain version's on the
    card, the float outputs within 2e-6 of each output's max, the
    gradients within 1e-5 of each gradient's max of the hand backward in
    torch ops, and two backward calls bit for bit equal."""
    kernels.reset_launches()
    got = KC.check_preprocess(n, n_alive, deg, cuda_device, seed=deg,
                              cam_grad=cam_grad)
    assert got["visible"] > n_alive // 2
    assert kernels.LAUNCHES["preprocess_fwd"] == 1
    assert kernels.LAUNCHES["preprocess_bwd"] == 2
    assert kernels.LAUNCHES["preprocess_reduce"] == (2 if cam_grad else 0)


def test_cuda_preprocess_camera_gradient_is_deterministic(cuda_device):
    """Through render(): two backward passes give the pose the same bits."""
    params, cam = scene(n=20000, device=cuda_device)
    grads = []
    for _ in range(2):
        q = cam.q_c2w.clone().requires_grad_(True)
        t = cam.t_c2w.clone().requires_grad_(True)
        o = render(params.xyz, G.get_features(params), G.get_opacity(params),
                   G.get_scaling(params), params.rotation,
                   cam._replace(q_c2w=q, t_c2w=t), 3, 128, 128)
        o["rendered_image"].square().mean().backward()
        grads.append((q.grad, t.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert grads[0][0].abs().max() > 0


def test_cuda_joint_iteration_launches_preprocess_twice_each_way(cuda_device):
    """One joint iteration renders twice (the static step with the pose
    gradient, the dynamic step without): 2 forward, 2 backward launches
    and 1 camera reduction."""
    import chip_smoke as CS

    joint, batch_for, _, _ = CS.joint_trainer(
        cuda_device, size=64, n_static=2000, cap_static=4096, n_dyn=400,
        cap_dyn=1024)
    for it in (481, 482):    # neither densifies
        kernels.reset_launches()
        joint.train_iteration(batch_for(it - 1), batch_for(it - 1), it)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["preprocess_fwd"] == 2, kernels.LAUNCHES
        assert kernels.LAUNCHES["preprocess_bwd"] == 2, kernels.LAUNCHES
        assert kernels.LAUNCHES["preprocess_reduce"] == 1, kernels.LAUNCHES
