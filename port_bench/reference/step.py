"""The reference's joint RoDyGS iteration: the static step (Gaussians and
camera poses), then the dynamic step (the static set detached and
concatenated with the deformed dynamic set; the Gaussians, the motion
coefficients and the motion net), each with the screen-space
densification statistic and Adam, in plain PyTorch on the frozen copies
beside this file. It follows `configs/train/train_kubric_mrig.yaml`'s
trainer block as the configuration file states it (`trainer` there), with
the pose-first warmup, the opacity reset and the SH ramp off, as they are
at the iterations the benchmark drives. Densification itself is not
followed: the iterations the reference follows have none.

The random draws (the local Pearson boxes, the rigidity sample and its
times) come from one generator per model, seeded as the harness seeded the
program's, and are drawn in the same order by the same calls (`losses.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import motion as M
from .camera import Camera
from .losses import MultiLoss
from .optim import AdamState, adam_init, adam_update, camera_lr_tree, tree_map
from .quaternion import quat_normalize
from .render import render
from .schedules import expon_lr


class GaussianParams(NamedTuple):
    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, 15, 3]
    scaling: torch.Tensor        # [C, 3] log
    rotation: torch.Tensor       # [C, 4] raw quaternion
    opacity: torch.Tensor        # [C, 1] logit


class DynParams(NamedTuple):
    gauss: GaussianParams
    motion_coeff: torch.Tensor   # [C, 1, B]
    net: dict


class Stats(NamedTuple):
    grad_accum: torch.Tensor
    denom: torch.Tensor
    max_radii2d: torch.Tensor


class Frame(NamedTuple):
    gt_image: torch.Tensor
    gt_depth: torch.Tensor
    frame_idx: int
    time: float
    fovx: float
    fovy: float


class State(NamedTuple):
    """Both models' trainable state."""

    static: GaussianParams
    static_alive: torch.Tensor
    poses: tuple                 # (q_c2w [F, 4], t_c2w [F, 3])
    static_opt: AdamState
    cam_opt: AdamState
    static_stats: Stats
    dynamic: DynParams
    dyn_alive: torch.Tensor
    time_ind: torch.Tensor
    dyn_opt: AdamState
    dyn_stats: Stats


def initial_state(static: GaussianParams, static_alive, poses,
                  dynamic: DynParams, dyn_alive, time_ind) -> State:
    def zeros_stats(c):
        z = torch.zeros((c,), device=static_alive.device)
        return Stats(z, z.clone(), z.clone())

    return State(static, static_alive, poses, adam_init(static),
                 adam_init(poses), zeros_stats(static.xyz.shape[0]), dynamic,
                 dyn_alive, time_ind, adam_init(dynamic),
                 zeros_stats(dynamic.gauss.xyz.shape[0]))


def features(p: GaussianParams):
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def opacity(p: GaussianParams):
    return torch.sigmoid(p.opacity[:, 0])


def accumulate(stats: Stats, g_offset, radii, visible) -> Stats:
    gnorm = torch.sqrt(g_offset[0] ** 2 + g_offset[1] ** 2)
    vis = visible.to(torch.float32)
    return Stats(stats.grad_accum + gnorm * vis, stats.denom + vis,
                 torch.maximum(stats.max_radii2d,
                               torch.where(visible, radii, 0.0)))


def gauss_lrs(t: dict, iteration: float, spatial: float) -> GaussianParams:
    xyz = expon_lr(iteration, t["position_lr_init"] * spatial,
                   t["position_lr_final"] * spatial,
                   lr_delay_mult=t["position_lr_delay_mult"],
                   max_steps=t["position_lr_max_steps"])
    return GaussianParams(xyz=xyz * 1.0, features_dc=t["feature_lr"] * 1.0,
                          features_rest=t["feature_lr"] / 20.0 * 1.0,
                          scaling=t["scaling_lr"] * 1.0,
                          rotation=t["rotation_lr"] * 1.0,
                          opacity=t["opacity_lr"] * 1.0)


def _grads(total, leaves):
    grads = torch.autograd.grad(total * 1.0, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


class Reference:
    """The two models' configuration; `iteration` runs one joint
    iteration on a `State`."""

    def __init__(self, cfg: dict, width: int, height: int,
                 unique_times: torch.Tensor):
        self.static_cfg = cfg["static"]
        self.dyn_cfg = cfg["dynamic"]
        self.spatial = float(cfg["spatial_lr_scale"])
        self.width, self.height = width, height
        self.static_loss = MultiLoss.from_config(cfg["static"]["losses"])
        self.dyn_loss = MultiLoss.from_config(cfg["dynamic"]["losses"])
        d = self.dyn_cfg
        self.net_cfg = M.MotionNetConfig(
            netwidth=d["deform_netwidth"], num_basis=d["num_basis"],
            t_emb_multires=d["deform_t_emb_multires"],
            t_log_sampling=d["deform_t_log_sampling"])
        self.unique_times = unique_times

    def static_step(self, s: State, frame: Frame, iteration: int,
                    gen: torch.Generator):
        c = self.static_cfg
        params = GaussianParams(*[p.detach().requires_grad_(True)
                                  for p in s.static])
        poses = tuple(p.detach().requires_grad_(True) for p in s.poses)
        offset = torch.zeros((2, params.xyz.shape[0]),
                             device=params.xyz.device, requires_grad=True)
        cam = _camera(poses, frame)
        out = render(params.xyz, features(params), opacity(params),
                     torch.exp(params.scaling), params.rotation, cam, 0,
                     self.width, self.height, s.static_alive, offset)
        ctx = {"pred_img": out["rendered_image"], "gt_img": frame.gt_image,
               "pred_depth": out["rendered_depth"],
               "gt_depth": frame.gt_depth,
               "pred_normal": torch.zeros_like(out["rendered_image"]),
               "motion_mask": None, "alive": s.static_alive, "rng": gen}
        total, _ = self.static_loss(ctx,
                                    self.static_loss.active_set(iteration))
        grads = _grads(total, [*params, *poses, offset])
        g_params = GaussianParams(*grads[:6])
        stats = accumulate(s.static_stats, grads[-1],
                           out["radii"].to(torch.float32),
                           out["visibility_filter"])
        it = float(iteration)
        with torch.no_grad():
            new_params, opt = adam_update(
                g_params, s.static_opt, GaussianParams(*[p.detach()
                                                        for p in params]),
                gauss_lrs(c, it, self.spatial))
            lrs = camera_lr_tree(it, c["camera_rotation_lr"],
                                 c["camera_translation_lr"],
                                 c["camera_lr_warmup"],
                                 c["camera_total_steps"])
            new_poses, cam_opt = adam_update(
                tuple(grads[6:8]), s.cam_opt,
                tuple(p.detach() for p in poses), tuple(lrs))
        return s._replace(static=new_params, poses=new_poses,
                          static_opt=opt, cam_opt=cam_opt,
                          static_stats=stats), total.detach()

    def deformation(self, p: DynParams, t, time_ind):
        return M.gaussian_deformation(
            p.net, self.net_cfg, p.motion_coeff,
            torch.tensor(t, dtype=torch.float32, device=time_ind.device),
            self.spatial, inverse_motion=True, time_ind=time_ind,
            times_table=self.unique_times)

    def dynamic_step(self, s: State, frame: Frame, iteration: int,
                     gen: torch.Generator):
        c = self.dyn_cfg
        sp = GaussianParams(*[p.detach() for p in s.static])
        params = tree_map(lambda x: x.detach().requires_grad_(True),
                          s.dynamic)
        gp = params.gauss
        transl, rot_delta = self.deformation(params, frame.time, s.time_ind)
        dyn_rot = quat_normalize(gp.rotation) + rot_delta
        cs = sp.xyz.shape[0]
        alive = torch.cat([s.static_alive, s.dyn_alive])
        offset = torch.zeros((2, alive.shape[0]), device=alive.device,
                             requires_grad=True)
        cam = _camera(tuple(p.detach() for p in s.poses), frame)
        out = render(torch.cat([sp.xyz, gp.xyz + transl]),
                     torch.cat([features(sp), features(gp)]),
                     torch.cat([opacity(sp), opacity(gp)]),
                     torch.cat([torch.exp(sp.scaling),
                                torch.exp(gp.scaling)]),
                     torch.cat([quat_normalize(sp.rotation), dyn_rot]), cam,
                     0, self.width, self.height, alive, offset)
        ctx = {"pred_img": out["rendered_image"], "gt_img": frame.gt_image,
               "pred_depth": out["rendered_depth"],
               "gt_depth": frame.gt_depth,
               "pred_normal": torch.zeros_like(out["rendered_image"]),
               "motion_mask": None, "rng": gen,
               "motion_coeff": params.motion_coeff, "canon_xyz": gp.xyz,
               "features_dc": gp.features_dc, "pred_translation": transl,
               "alive": s.dyn_alive,
               "motion_table": M.motion_table(params.net, self.net_cfg,
                                              self.unique_times)}
        total, _ = self.dyn_loss(ctx, self.dyn_loss.active_set(iteration))
        leaves = []
        tree_map(leaves.append, params)
        grads = iter(_grads(total, leaves + [offset]))
        g_params = tree_map(lambda _: next(grads), params)
        g_offset = next(grads)
        stats = accumulate(s.dyn_stats, g_offset[:, cs:],
                           out["radii"][cs:].to(torch.float32),
                           out["visibility_filter"][cs:])
        it = float(iteration)
        deform_lr = c["deform_lr_init"] * 1.0
        lrs = DynParams(gauss=gauss_lrs(c, it, self.spatial),
                        motion_coeff=c["motion_coeff_lr"] * 1.0,
                        net=tree_map(lambda _: deform_lr, params.net))
        with torch.no_grad():
            new_params, opt = adam_update(
                g_params, s.dyn_opt, tree_map(lambda x: x.detach(), params),
                lrs)
        return s._replace(dynamic=new_params, dyn_opt=opt,
                          dyn_stats=stats), total.detach()

    def iteration(self, s: State, frame: Frame, iteration: int, gens):
        """(state after the joint iteration, (static loss, dynamic loss))."""
        s, l_static = self.static_step(s, frame, iteration, gens[0])
        s, l_dyn = self.dynamic_step(s, frame, iteration, gens[1])
        return s, (l_static, l_dyn)


def _camera(poses, frame: Frame) -> Camera:
    dev = poses[0].device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return Camera(q_c2w=poses[0][frame.frame_idx],
                  t_c2w=poses[1][frame.frame_idx], fovx=f32(frame.fovx),
                  fovy=f32(frame.fovy), time=f32(frame.time))
