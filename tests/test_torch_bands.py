"""Sort bands of the PyTorch port against the JAX package on the CPU.

`build_binning(bands=B)` splits the fragment structure into B tile-row
ranges, each enumerated and sorted on its own. The same numpy-seeded scene
goes through both packages: the banded index structure must be equal
exactly in all three tight modes and under a forced overflow, the banded
render must meet the render suite's bars (image 2e-5, gradients divided by
their max 5e-4), and the port's banded image must keep the bits of its
unbanded one (the per-tile fragment sets and their order are the same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.render import compact as jc
from rodygs_tpu.render.binning import tile_grid
from rodygs_tpu.render.preprocess import preprocess as jpreprocess
from rodygs_tpu.render.rasterize import render as jrender
from rodygs_tpu_torch.render import compact as tc
from rodygs_tpu_torch.render.rasterize import render as trender

from test_render import H, W, make_scene
from test_torch_render import (IMG_TOL, T, assert_scaled, splats_to_torch,
                               tcam_from)


@pytest.fixture(scope="module")
def scene_splats():
    means, scales, quats, opac, shs, cam = make_scene(n=300, sh_extra=True)
    return jpreprocess(means, scales, quats, opac, shs, 3, cam, W, H)


def _assert_binning_equal(jb, tb):
    for name in jb._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)


@pytest.mark.parametrize("bands", [2, 3])
@pytest.mark.parametrize("tight", [False, True, "rows"])
def test_banded_binning_exact(scene_splats, tight, bands):
    tx, ty = tile_grid(W, H)
    cap = jc.fragment_capacity(300, "lean")
    jb = jc.build_binning(scene_splats, tx, ty, cap, tight=tight, bands=bands)
    tb = tc.build_binning(splats_to_torch(scene_splats), tx, ty, cap,
                          tight=tight, bands=bands)
    assert tb.aux_rows.shape[0] == tb.bases.shape[0] == tb.f_kept.shape[0] \
        == bands
    assert tb.bases.shape[1] * tc.FCHUNK == tc.band_cap(cap, bands)
    assert not bool(tb.overflow)
    _assert_binning_equal(jb, tb)
    # every band holds fragments: the boundaries really split the rows
    assert (tb.f_kept > 0).all()


@pytest.mark.parametrize("tight", [True, "rows"])
def test_banded_binning_overflow_matches(scene_splats, tight):
    tx, ty = tile_grid(W, H)
    cap = 1024    # 512 slots a band, far below either band's demand
    jb = jc.build_binning(scene_splats, tx, ty, cap, tight=tight, bands=2)
    tb = tc.build_binning(splats_to_torch(scene_splats), tx, ty, cap,
                          tight=tight, bands=2)
    assert bool(jb.overflow) and bool(tb.overflow) and int(tb.dropped) > 0
    _assert_binning_equal(jb, tb)


def test_band_count_clamped_to_tile_rows(scene_splats):
    tx, ty = tile_grid(W, H)
    cap = jc.fragment_capacity(300, "lean")
    tb = tc.build_binning(splats_to_torch(scene_splats), tx, ty, cap,
                          tight=True, bands=ty + 3)
    jb = jc.build_binning(scene_splats, tx, ty, cap, tight=True, bands=ty + 3)
    assert tb.f_kept.shape == (ty,)
    _assert_binning_equal(jb, tb)


def _render_and_grads(scene, bands=None, profile="lean", sh_degree=2,
                      include_normal=True):
    """Port render with gradients of a seeded loss."""
    means, scales, quats, opac, shs, cam = scene
    target = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    leaves = [T(x).requires_grad_(True) for x in (means, scales, quats, opac,
                                                  shs)]
    tcam = tcam_from(cam, requires_grad=True)
    out = trender(leaves[0], leaves[4], leaves[3], leaves[1], leaves[2], tcam,
                  sh_degree, W, H, fragment_profile=profile, sort_bands=bands,
                  include_normal=include_normal)
    loss = (torch.mean((out["rendered_image"] - torch.tensor(target)) ** 2)
            + 0.1 * torch.mean(out["rendered_depth"]))
    loss.backward()
    grads = [x.grad.numpy() for x in leaves] + [tcam.q_c2w.grad.numpy(),
                                                tcam.t_c2w.grad.numpy()]
    return out, grads, target


@pytest.mark.parametrize("include_normal", [True, False])
@pytest.mark.parametrize("bands", [2, 3])
def test_banded_render_matches_jax(bands, include_normal):
    """Without the normal rows the banded backward takes each band's 10
    core gradient rows."""
    scene = make_scene(n=120, sh_extra=True)
    means, scales, quats, opac, shs, cam = scene
    out, grads, target = _render_and_grads(scene, bands=bands,
                                           include_normal=include_normal)

    def jloss(means, scales, quats, opac, shs, cam):
        o = jrender(means, shs, opac, scales, quats, cam, 2, W, H,
                    sort_bands=bands, include_normal=include_normal)
        return (jnp.mean((o["rendered_image"] - target) ** 2)
                + 0.1 * jnp.mean(o["rendered_depth"])), o

    (_, jo), gj = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                     has_aux=True)(means, scales, quats, opac,
                                                   shs, cam)
    np.testing.assert_allclose(out["rendered_image"].detach().numpy(),
                               np.asarray(jo["rendered_image"]), atol=IMG_TOL)
    for k in ("num_fragments", "overflow", "dropped"):
        assert int(out[k]) == int(jo[k]), k
    names = ["means", "scales", "quats", "opac", "shs"]
    for name, a, b in zip(names, gj[:5], grads[:5]):
        assert_scaled(a, b, name=name)
    assert_scaled(gj[5].q_c2w, grads[5], name="q_c2w")
    assert_scaled(gj[5].t_c2w, grads[6], name="t_c2w")


@pytest.mark.parametrize("bands", [2, 3])
def test_banded_render_keeps_unbanded_image_bits(bands):
    scene = make_scene(n=300, sh_extra=True)
    one, g1, _ = _render_and_grads(scene)
    banded, gb, _ = _render_and_grads(scene, bands=bands)
    for k in ("rendered_image", "rendered_depth", "rendered_alpha"):
        assert torch.equal(banded[k], one[k]), k
    # the bands sum a gaussian's slots in another grouping
    for a, b in zip(g1, gb):
        assert_scaled(a, b)


def test_profile_tuple_reaches_the_banded_path(monkeypatch):
    """A (profile, bands) fragment profile, as the pollers and the evaluator
    hand it over, renders exactly as sort_bands does; sort_bands wins over
    the profile's count."""
    seen = []
    real = tc.build_binning

    def spy(*args, **kwargs):
        seen.append(kwargs["bands"])
        return real(*args, **kwargs)

    monkeypatch.setattr("rodygs_tpu_torch.render.rasterize.build_binning", spy)
    scene = make_scene(n=300, sh_extra=True)
    via_profile, gp, _ = _render_and_grads(scene, profile=("lean", 2))
    via_arg, ga, _ = _render_and_grads(scene, bands=2)
    forced, _, _ = _render_and_grads(scene, bands=1, profile=("lean", 3))
    assert seen == [2, 2, 1]
    assert torch.equal(via_profile["rendered_image"], via_arg["rendered_image"])
    for a, b in zip(gp, ga):
        np.testing.assert_array_equal(a, b)
    assert forced["rendered_image"].shape == (H, W, 3)


@pytest.mark.parametrize("shape,bands", [((2, 24, 512), 1), ((24, 512), 2)])
def test_table_rank_must_match_bands(shape, bands):
    """A banded structure takes a [B, R, Nw] table, an unbanded one [R,
    Nw]: anything else raises before the kernels run."""
    with pytest.raises(ValueError, match=f"bands={bands}"):
        tc.composite_compact(torch.zeros(shape), None, None, None, None,
                             None, 4, 3, bands=bands)
