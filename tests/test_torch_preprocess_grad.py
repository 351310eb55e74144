"""The projection stage's hand-derived backward against autograd.

`preprocess_backward_plain` is the chain rule that csrc/preprocess.cu's
backward computes, written in torch ops; here it is held against
`torch.autograd.grad` of the plain version (`_project_plain`, the
formula-by-formula oracle) for every differentiable output and for the
camera's three gradients (w2c, full_proj, campos), over SH degrees 0-3,
with and without `alive`, `pose_grad_only` and `colors_precomp`. The inputs
hold slots behind the near plane, slots whose det rounds to <= 0, dead
slots, slots on the frustum clamp and slots whose colour falls below 0.

This file imports neither JAX nor the JAX package.
"""

import itertools

import numpy as np
import pytest
import torch

from rodygs_tpu_torch import kernels
from rodygs_tpu_torch.render import preprocess as P
from rodygs_tpu_torch.render.camera import make_camera

W, H, N, K = 64, 48, 160, 16
TOL = 1e-5          # relative to each gradient's max
OUTPUTS = ("mean2d", "conic", "depth", "rgb", "normal")
INPUTS = ("means3d", "scales", "quats", "shs", "colors_precomp", "w2c",
          "full_proj", "campos")


def edge_scene(seed=0):
    """N Gaussians with every branch of the projection represented; returns
    (inputs dict, alive, camera)."""
    rng = np.random.default_rng(seed)
    cam = make_camera([0.95, 0.1, -0.2, 0.05], [0.2, -0.1, -3.0], 0.9, 0.75,
                      device="cpu")
    w2c, _, _ = P._camera(cam)
    R, t = w2c[:3, :3].numpy(), w2c[:3, 3].numpy()
    # view-space positions, mapped back to the world
    z = rng.uniform(0.5, 6.0, N)
    x = rng.uniform(-0.5, 0.5, N) * z
    y = rng.uniform(-0.4, 0.4, N) * z
    z[:12] = rng.uniform(-1.0, 0.19, 12)          # behind the near plane
    x[12:30] = rng.choice([-1, 1], 18) * rng.uniform(0.9, 3.0, 18) * z[12:30]
    y[30:40] = rng.choice([-1, 1], 10) * rng.uniform(0.8, 2.0, 10) * z[30:40]
    view = np.stack([x, y, z], 1)
    means = (view - t) @ R                         # R^T (v - t), row-wise
    scales = rng.uniform(0.01, 0.3, (N, 3))
    quats = rng.normal(size=(N, 4))
    # needles near the camera: a and c ~ 1e12, det rounds to <= 0 for some
    scales[40:56] = [3e3, 1e-4, 1e-4]
    means[40:56] = ((np.stack([rng.uniform(-0.05, 0.05, 16),
                               rng.uniform(-0.05, 0.05, 16),
                               np.full(16, 0.3)], 1) - t) @ R)
    quats[40:56] = [np.cos(0.3), 0.3, 0.7, 0.5]
    shs = rng.normal(0, 0.6, (N, K, 3))
    alive = np.ones(N, bool)
    alive[60:75] = False
    means[60:75] = scales[60:75] = quats[60:75] = shs[60:75] = 0.0
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    ins = dict(means3d=f32(means), scales=f32(scales), quats=f32(quats),
               shs=f32(shs), colors_precomp=f32(rng.uniform(-0.3, 1, (N, 3))),
               opacities=f32(rng.uniform(0.01, 1, N)))
    return ins, torch.tensor(alive), cam


def _cotangents(seed, which):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(mean2d=(2, N), conic=(3, N), depth=(N,), rgb=(3, N),
                  normal=(3, N))
    return tuple(torch.randn(shapes[k], generator=g) if k in which else None
                 for k in OUTPUTS)


@pytest.fixture(scope="module")
def scene():
    ins, alive, cam = edge_scene()
    w2c, full_proj, campos = (x.detach() for x in P._camera(cam))
    return ins, alive, cam, w2c, full_proj, campos


def test_edge_scene_holds_every_branch(scene):
    ins, alive, cam, w2c, full_proj, campos = scene
    with torch.no_grad():
        t = P._terms(ins["means3d"], ins["scales"], ins["quats"], None,
                     ins["shs"], 3, P._rows(w2c, 3), P._rows(full_proj, 4),
                     campos, cam.fovx, cam.fovy, W, H, 1.0, alive, True)
    assert (~t.depth_ok).sum() >= 10
    assert (~t.det_ok & t.depth_ok).sum() >= 1
    lim_x, lim_y = t.lim
    assert (t.u[0].abs() > lim_x).sum() >= 10
    assert (t.u[1].abs() > lim_y).sum() >= 5
    assert (torch.stack(t.rgb_pre) < 0).sum() >= 10
    assert (~alive).sum() >= 10


@pytest.mark.parametrize("deg,with_alive,pose_grad_only,with_colors",
                         list(itertools.product(range(4), [False, True],
                                                [False, True],
                                                [False, True])))
def test_backward_plain_matches_autograd(scene, deg, with_alive,
                                         pose_grad_only, with_colors):
    """Every input's gradient, for the cotangents of all outputs at once
    and of each output alone, within 1e-5 of the gradient's max."""
    ins, alive, cam, w2c, full_proj, campos = scene
    quats = ins["quats"]
    if not with_alive:   # no dead slots: every quaternion a rotation
        quats = torch.where(alive[:, None], quats,
                            torch.tensor([1.0, 0.0, 0.0, 0.0]))
    alive = alive if with_alive else None
    leaves = dict(means3d=ins["means3d"], scales=ins["scales"],
                  quats=quats, shs=ins["shs"],
                  colors_precomp=ins["colors_precomp"] if with_colors
                  else None, w2c=w2c, full_proj=full_proj, campos=campos)
    leaves = {k: None if v is None else v.clone().requires_grad_(True)
              for k, v in leaves.items()}
    splats = P._splats(P._project_plain(
        leaves["means3d"], leaves["scales"], leaves["quats"],
        ins["opacities"], leaves["shs"], deg, leaves["w2c"],
        leaves["full_proj"], leaves["campos"], cam.fovx, cam.fovy, W, H,
        0.9, alive, leaves["colors_precomp"]), ins["opacities"],
        pose_grad_only)
    outs = [getattr(splats, k) for k in OUTPUTS]
    live = [k for k, o in zip(OUTPUTS, outs) if o.requires_grad]
    needs = tuple(v is not None for v in leaves.values())
    for s, which in enumerate([live] + [[k] for k in live]):
        cots = _cotangents(s, which)
        pairs = [(o, c) for o, c in zip(outs, cots) if c is not None]
        want = torch.autograd.grad(
            [o for o, _ in pairs], [v for v in leaves.values()
                                    if v is not None],
            [c for _, c in pairs], retain_graph=True, allow_unused=True)
        want = iter(want)
        want = [next(want) if v is not None else None
                for v in leaves.values()]
        got = P.preprocess_backward_plain(
            ins["means3d"], ins["scales"], quats, ins["shs"], w2c,
            full_proj, campos, alive, cam.fovx, cam.fovy, deg, W, H, 0.9,
            with_colors, cots, needs)
        for name, a, b in zip(INPUTS, want, got):
            if a is None:    # not reached: the hand backward gives 0 or None
                assert b is None or not b.any(), (name, which)
                continue
            scale = float(a.abs().max())
            err = float((a - b).abs().max()) / max(scale, 1e-30)
            assert err <= TOL, (name, which, err, scale)


def _leaves(ins, names):
    return {k: (v.clone().requires_grad_(True) if k in names else v)
            for k, v in ins.items()}


def test_no_grad_saves_nothing_and_unneeded_grads_are_none(scene,
                                                           monkeypatch):
    """Under no_grad, or with no input needing a gradient, the Function is
    not applied (nothing saved, outputs without a graph). With only the
    quaternions needing one, the backward returns None for every other
    input, and nothing accumulates into them."""
    ins, alive, cam, *_ = scene

    def call(x):
        return P.preprocess(x["means3d"], x["scales"], x["quats"],
                            x["opacities"], x["shs"], 2, cam, W, H,
                            alive=alive)

    applied = []
    real_apply = P._Preprocess.apply
    monkeypatch.setattr(P._Preprocess, "apply",
                        lambda *a: applied.append(1) or real_apply(*a))
    with torch.no_grad():
        out = call(_leaves(ins, ("means3d", "quats")))
    assert not applied and all(o.grad_fn is None for o in out)
    out = call(ins)
    assert not applied and all(o.grad_fn is None for o in out)

    returned = []
    real_back = P.preprocess_backward_plain
    monkeypatch.setattr(P, "preprocess_backward_plain",
                        lambda *a: returned.append(real_back(*a))
                        or returned[-1])
    x = _leaves(ins, ("quats",))
    out = call(x)
    assert applied == [1]
    (out.conic.sum() + out.rgb.sum() + out.mean2d.sum()).backward()
    got, = returned
    assert got[2] is not None and got[2].shape == (N, 4)
    assert all(g is None for k, g in enumerate(got) if k != 2)
    assert x["quats"].grad is not None
    assert all(x[k].grad is None for k in ("means3d", "scales", "shs"))
    assert kernels.LAUNCHES["preprocess_fwd"] == 0


def test_cpu_forward_is_the_plain_version(scene):
    """On the CPU the Function's forward is the plain version's arithmetic:
    every output equal, bit for bit, with and without a graph."""
    ins, alive, cam, *_ = scene
    args = (ins["means3d"], ins["scales"], ins["quats"], ins["opacities"],
            ins["shs"], 3, cam, W, H, 0.9)
    want = P.preprocess_plain(*args, alive=alive)
    x = _leaves(ins, ("means3d", "shs"))
    for got in (P.preprocess(*args, alive=alive),
                P.preprocess(x["means3d"], *args[1:4], x["shs"], *args[5:],
                             alive=alive)):
        for name, a, b in zip(want._fields, want, got):
            assert torch.equal(a, b.detach()), name
