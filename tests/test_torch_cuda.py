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
from hypothesis import given, settings
from hypothesis import strategies as st

from rodygs_tpu_torch import kernel_check as KC
from rodygs_tpu_torch import kernels
from rodygs_tpu_torch.models import gaussians as G
from rodygs_tpu_torch.render import compact as C
from rodygs_tpu_torch.render import tile_kernel as TK
from rodygs_tpu_torch.render.rasterize import render

SIZE = 64


def scene(n=1500, seed=3, opacity=(0.2, 0.95), device="cpu"):
    return KC.random_scene(n, seed, device, opacity=opacity)


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
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS) == {
        "expand", "tile_fwd", "tile_bwd", "segsum"}
    assert all(name.endswith((".cu", ".cuh"))
               for name in [p.name for p in kernels._CSRC.iterdir()])


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
