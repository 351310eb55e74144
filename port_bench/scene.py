"""The seeded scene of a configuration: the GT stores and the trainers'
initial state, drawn on the device from `--seed` in a few large calls.
The draws follow `tools/flagship_1080p.make_scene` (uniform static and
dynamic volumes with trained-like footprints, a velocity per dynamic
gaussian, a birth frame each, init clouds at the GT centres plus noise with
inflated footprints, opacity 0.1, cameras on an arc). Both the program and
the reference are handed these tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference import step as R
from .reference.render import render
from .reference.sh import C0


class Scene(NamedTuple):
    width: int
    height: int
    frames: list                 # [R.Frame]: GT image, depth, time, fov
    poses: tuple                 # (q_c2w [F, 4], t_c2w [F, 3])
    static: R.GaussianParams     # initial, capacity slots
    static_alive: torch.Tensor
    dynamic: R.DynParams
    dyn_alive: torch.Tensor
    dyn_time: torch.Tensor       # [C] birth time
    time_ind: torch.Tensor       # [C] i32 index into unique_times
    unique_times: torch.Tensor   # [T]


def _uniform(g, lo, hi, n):
    lo = torch.tensor(lo, dtype=torch.float32, device=g.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=g.device)
    return lo + (hi - lo) * torch.rand((n, lo.numel()), generator=g,
                                       device=g.device)


def _params(xyz, cols, log_scales, capacity: int) -> R.GaussianParams:
    """A store of `capacity` slots, the first len(xyz) alive: DC colour
    from RGB, higher SH bands zero, identity rotations, opacity 0.1."""
    n, dev = xyz.shape[0], xyz.device

    def padded(x, fill=0.0):
        pad = x.new_full((capacity - n,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, pad])

    rot = torch.zeros((n, 4), device=dev)
    rot[:, 0] = 1.0
    return R.GaussianParams(
        xyz=padded(xyz), features_dc=padded(((cols - 0.5) / C0)[:, None]),
        features_rest=torch.zeros((capacity, 15, 3), device=dev),
        scaling=padded(log_scales, math.log(1e-6)), rotation=padded(rot),
        opacity=padded(torch.full((n, 1), math.log(0.1 / 0.9), device=dev)))


def motion_net(g, cfg: dict) -> dict:
    """The motion-basis MLP's weights: N(0, 1/fan_in), zero biases."""
    w, b = cfg["deform_netwidth"], cfg["num_basis"]
    d = 2 * cfg["deform_t_emb_multires"] + 1

    def normal(*shape):
        return torch.randn(shape, generator=g, device=g.device) / math.sqrt(
            shape[-2])

    def zeros(*shape):
        return torch.zeros(shape, device=g.device)

    return {"timenet": {"w0": normal(d, w), "b0": zeros(w),
                        "w1": normal(w, w), "b1": zeros(w),
                        "w2": normal(w, w // 2), "b2": zeros(w // 2)},
            "heads": {"w0": normal(b, w // 2, w // 4), "b0": zeros(b, w // 4),
                      "w1": normal(b, w // 4, 7), "b1": zeros(b, 7)}}


def build(cfg: dict, seed: int, device) -> Scene:
    s = cfg["scene"]
    n, cap, nf = cfg["num_limit_points"], cfg["capacity"], cfg["frames"]
    g = torch.Generator(device=device).manual_seed(seed)

    def log_u(lo, hi):
        return _uniform(g, [lo] * 3, [hi] * 3, n)

    sm = _uniform(g, *s["static_box"], n)
    s_log = log_u(*s["static_log_scale"])
    s_cols = _uniform(g, [0.05] * 3, [0.95] * 3, n)
    dm0 = _uniform(g, *s["dynamic_box"], n)
    d_log = log_u(*s["dynamic_log_scale"])
    d_cols = _uniform(g, [0.05] * 3, [0.95] * 3, n)
    vel = _uniform(g, [-s["speed"]] * 3, [s["speed"]] * 3, n)
    noise = s["init_noise"]
    sm_init = sm + noise * torch.randn(sm.shape, generator=g, device=device)
    birth = torch.randint(0, nf, (n,), generator=g, device=device)
    birth_t = birth.to(torch.float32) / (nf - 1)
    dm_init = (dm0 + vel * birth_t[:, None]
               + noise * torch.randn(dm0.shape, generator=g, device=device))
    inflate = math.log(s["scale_inflate"])
    coeff = torch.zeros((cap, 1, cfg["trainer"]["dynamic"]["num_basis"]),
                        device=device)
    coeff[:n] = s["coeff_std"] * torch.randn(
        (n, 1, coeff.shape[2]), generator=g, device=device)
    net = motion_net(g, cfg["trainer"]["dynamic"])

    alive = torch.arange(cap, device=device) < n
    times = torch.zeros((cap,), device=device)
    times[:n] = birth_t
    unique, inverse = torch.unique(birth_t, sorted=True, return_inverse=True)
    time_ind = torch.zeros((cap,), dtype=torch.int32, device=device)
    time_ind[:n] = inverse.to(torch.int32)

    angles = np.linspace(-s["arc"], s["arc"], nf)
    q = torch.tensor(np.stack([[math.cos(a / 2), 0.0, math.sin(a / 2), 0.0]
                               for a in angles]), dtype=torch.float32,
                     device=device)
    t = torch.tensor(np.stack([[math.sin(a) * s["arc_radius"], 0.0, 0.0]
                               for a in angles]), dtype=torch.float32,
                     device=device)
    frames = gt_frames(cfg, (sm, s_log, s_cols), (dm0, d_log, d_cols), vel,
                       (q, t))
    return Scene(
        width=cfg["width"], height=cfg["height"], frames=frames, poses=(q, t),
        static=_params(sm_init, s_cols, s_log + inflate, cap),
        static_alive=alive.clone(),
        dynamic=R.DynParams(gauss=_params(dm_init, d_cols, d_log + inflate,
                                          cap),
                            motion_coeff=coeff, net=net),
        dyn_alive=alive, dyn_time=times, time_ind=time_ind,
        unique_times=unique)


@torch.no_grad()
def gt_frames(cfg: dict, static, dynamic, vel, poses) -> list:
    """The GT views: the GT static set plus the GT dynamic set moved to the
    frame's time, rendered by the reference; image clipped to [0, 1] and
    the depth channel as the depth prior."""
    nf, w, h = cfg["frames"], cfg["width"], cfg["height"]
    n = static[0].shape[0]
    frames = []
    for i in range(nf):
        ti = i / (nf - 1)
        xyz = torch.cat([static[0], dynamic[0] + vel * ti])
        p = _params(xyz, torch.cat([static[2], dynamic[2]]),
                    torch.cat([static[1], dynamic[1]]), 2 * n)
        cam = R.Frame(None, None, i, ti, cfg["fovx"], cfg["fovy"])
        out = render(p.xyz, R.features(p), R.opacity(p), torch.exp(p.scaling),
                     p.rotation, R._camera(poses, cam), 0, w, h,
                     torch.ones((2 * n,), dtype=torch.bool,
                                device=xyz.device))
        frames.append(cam._replace(
            gt_image=torch.clamp(out["rendered_image"], 0.0, 1.0),
            gt_depth=out["rendered_depth"].contiguous()))
    return frames
