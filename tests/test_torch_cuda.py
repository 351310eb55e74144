"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the kernel-check helpers and wrapper guards on the CPU.

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed. On the machine with the card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX for the parity suite.)
Tests that need the card take the `cuda_device` fixture and skip without
one; the kernels have no CPU mode.
"""

import pytest
import torch

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
    assert all(name.endswith(".cu") or name == "common.cuh"
               for name in [p.name for p in kernels._CSRC.iterdir()])


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
