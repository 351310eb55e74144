"""Dynamic (motion-basis) Gaussian trainer. Port of
`rodygs_tpu/train/trainer_dynamic.py` (`DynTrainerConfig`, `DynParams`,
`DynTrainState`, `DynTrainer`).

The static trainer's Gaussian params plus the motion coefficients and the
motion net, one Adam over all of them; densification moves the
coefficients and their moments with their Gaussians. Rendering happens in
the joint trainer (trainer_joint.py), on the static set concatenated with
the deformed dynamic set.

Multi-device (`mesh=`): the dynamic state stays whole on every rank (with
a gauss axis its slots are interleaved first); densification runs per
gauss shard on the rank's slice, with a generator seeded per shard, and
the slices are gathered again (parallel/sharded.py).

Reference behaviour kept: the reference builds an exponential deform-LR
schedule but never applies it (its LR update matches the group name
"deform" while the group is "deform_network"), so the deform LR stays at
`deform_lr_init` unless `apply_deform_lr_decay=True`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models import gaussians as G
from ..models import motion as M
from ..ops.schedules import expon_lr
from ..utils.platform import resolve_device
from ..utils.profiling import span
from ..render.rasterize import render
from .densify import DensifyStats, densify_and_prune, init_stats
from .losses import MultiLoss
from .optim import (AdamState, CameraPoses, adam_init, adam_update,
                    tree_leaves, tree_map)
from .trainer_static import (FrameBatch, StaticTrainerConfig, _param_lr_tree,
                             densify_due, make_camera_from_poses,
                             scene_lr_gate, screen_size_threshold)


@dataclasses.dataclass(frozen=True)
class DynTrainerConfig(StaticTrainerConfig):
    """Adds the motion model's parameters (kubric_mrig dynamic-trainer
    defaults)."""

    deform_lr_init: float = 0.0016
    deform_lr_final: float = 0.00016
    deform_lr_delay_mult: float = 0.01
    deform_lr_max_steps: int = 20000
    motion_coeff_lr: float = 0.00016
    deform_warmup_steps: int = 0
    apply_deform_lr_decay: bool = False  # reference bug: decay never applies
    deform_netwidth: int = 128
    deform_t_emb_multires: int = 26
    deform_t_log_sampling: bool = False
    num_basis: int = 16
    inverse_motion: bool = True
    activation: str = "gelu"


class DynParams(NamedTuple):
    """All trainable leaves of the dynamic model."""

    gauss: G.GaussianParams
    motion_coeff: torch.Tensor  # [C, 1, B]
    net: dict                   # motion-basis MLP params


class DynTrainState(NamedTuple):
    store: G.GaussianStore
    motion_coeff: torch.Tensor
    net: dict
    opt: AdamState     # over DynParams
    stats: DensifyStats


class DynTrainer:
    """Owns the dynamic state, its optimizer and learning rates, and its
    densification. `seed` seeds the trainer's generator, which draws the
    motion net's initial weights, the dynamic losses' samples and the split
    samples."""

    def __init__(self, cfg: DynTrainerConfig, loss: MultiLoss,
                 store: G.GaussianStore, spatial_lr_scale: float,
                 seed: int = 0, device=None, mesh=None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.cfg = cfg
        self.loss = loss
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.net_cfg = M.MotionNetConfig(
            netwidth=cfg.deform_netwidth,
            num_basis=cfg.num_basis,
            t_emb_multires=cfg.deform_t_emb_multires,
            t_log_sampling=cfg.deform_t_log_sampling,
            activation=cfg.activation,
        )
        store = tree_map(lambda x: x.to(self.device), store)
        n_gauss = 1 if mesh is None else mesh.shape["gauss"]
        if n_gauss > 1:
            store = G.shard_interleave(store, n_gauss)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.densify_gen = self.gen
        cap = G.capacity_of(store)
        net = M.init_motion_params(self.gen, self.net_cfg, self.device)
        coeff = torch.zeros((cap, 1, cfg.num_basis), device=self.device)
        params = DynParams(gauss=store.params, motion_coeff=coeff, net=net)
        self.state = DynTrainState(
            store=store, motion_coeff=coeff, net=net,
            opt=adam_init(params), stats=init_stats(cap, device=self.device))
        self.active_sh_degree = 0
        # the unique birth times: the inverse-motion canonicalisation table
        self.unique_times = torch.tensor(G.unique_times(store),
                                         dtype=torch.float32, device=self.device)
        if mesh is not None:
            from ..parallel import sharded

            if n_gauss > 1:
                self.densify_gen = torch.Generator(
                    device=self.device).manual_seed(
                        sharded.fold_in_seed(seed, mesh.coords["gauss"]))
            self._sharded_densify = sharded.make_sharded_dynamic_densify(
                self.densify_block, mesh)

    @staticmethod
    def params_of(state: DynTrainState) -> DynParams:
        return DynParams(gauss=state.store.params,
                         motion_coeff=state.motion_coeff, net=state.net)

    def params(self) -> DynParams:
        return self.params_of(self.state)

    def lr_tree(self, iteration) -> DynParams:
        cfg = self.cfg
        gauss = _param_lr_tree(cfg, iteration, self.spatial_lr_scale)
        if cfg.apply_deform_lr_decay:
            deform_lr = expon_lr(
                iteration, cfg.deform_lr_init, cfg.deform_lr_final,
                lr_delay_mult=cfg.deform_lr_delay_mult,
                max_steps=cfg.deform_lr_max_steps)
        else:
            deform_lr = cfg.deform_lr_init
        gate = scene_lr_gate(cfg, iteration)  # pose-first warmup
        return DynParams(gauss=gauss,
                         motion_coeff=cfg.motion_coeff_lr * gate,
                         net=tree_map(lambda _: deform_lr * gate, self.state.net))

    def deformation(self, params: DynParams, t, time_ind):
        return M.gaussian_deformation(
            params.net, self.net_cfg, params.motion_coeff, t,
            self.spatial_lr_scale, inverse_motion=self.cfg.inverse_motion,
            time_ind=time_ind, times_table=self.unique_times)

    def motion_table(self, params: DynParams):
        return M.motion_table(params.net, self.net_cfg, self.unique_times)

    def loss_and_grads(self, dyn_state: DynTrainState,
                       static_store: G.GaussianStore, poses: CameraPoses,
                       batch: FrameBatch, active, sh_degree: int,
                       use_deform: bool, fragment_profile="lean",
                       dyn_rows: slice = slice(None), tile_axis=None,
                       gauss_axis=None, loss_scale: float = 1.0):
        """The first half of a dynamic step: render the static set (and
        poses) detached, concatenated with the deformed dynamic rows
        `dyn_rows`; the loss, aux outputs and the gradients (DynParams, the
        `means2d` offset over [static | dyn_rows]). On a mesh
        (parallel/sharded.py) `static_store` is this rank's gauss block,
        `dyn_rows` its slice of the replicated dynamic store, the render
        splits over `tile_axis` / `gauss_axis`, `radii` / `visible` cover
        the gathered set, and the differentiated loss is `total *
        loss_scale`."""
        cfg = self.cfg
        sp = tree_map(lambda x: x.detach(), static_store.params)
        params = tree_map(lambda x: x.detach().requires_grad_(True),
                          self.params_of(dyn_state))
        gp = params.gauss
        cd = G.capacity_of(dyn_state.store)
        if use_deform:
            transl, rot_delta = self.deformation(params, batch.time,
                                                 dyn_state.store.time_ind)
        else:
            transl = torch.zeros_like(gp.xyz)
            rot_delta = torch.zeros((cd, 4), device=gp.xyz.device)
        dyn_rot = G.get_rotation(gp)
        if not cfg.isotropic:
            dyn_rot = dyn_rot + rot_delta
        d_alive = dyn_state.store.alive

        def cat(s, d):
            return torch.cat([s, d[dyn_rows]])

        alive = cat(static_store.alive, d_alive)
        offset = torch.zeros((2, alive.shape[0]), device=alive.device,
                             requires_grad=True)
        out = render(
            cat(sp.xyz, gp.xyz + transl),
            cat(G.get_features(sp), G.get_features(gp)),
            cat(G.get_opacity(sp), G.get_opacity(gp)),
            cat(G.get_scaling(sp, cfg.isotropic),
                G.get_scaling(gp, cfg.isotropic)),
            cat(G.get_rotation(sp), dyn_rot),
            make_camera_from_poses(CameraPoses(*[p.detach() for p in poses]),
                                   batch),
            sh_degree, cfg.image_width, cfg.image_height, alive=alive,
            means2d_offset=offset, max_fragments=cfg.max_fragments,
            fragment_profile=fragment_profile,
            include_normal=self.loss.uses_normal, tile_axis=tile_axis,
            gauss_axis=gauss_axis)
        ctx = {
            "pred_img": out["rendered_image"],
            "gt_img": batch.gt_image,
            "pred_depth": out["rendered_depth"],
            "gt_depth": batch.gt_depth,
            "pred_normal": out["rendered_normal"],
            "motion_mask": batch.motion_mask,
            "rng": self.gen,
            # the model terms read the whole dynamic store
            "motion_coeff": params.motion_coeff,
            "canon_xyz": gp.xyz,
            "features_dc": gp.features_dc,
            "pred_translation": transl,
            "alive": d_alive,
            "motion_table": self.motion_table(params),
        }
        total, loss_dict = self.loss(ctx, active)
        leaves = tree_leaves(params) + [offset]
        with span("backward"):
            grads = torch.autograd.grad(total * loss_scale, leaves,
                                        allow_unused=True)
        grads = iter([torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads)])
        g_params = tree_map(lambda _: next(grads), params)
        aux = {
            "radii": out["radii"],
            "visible": out["visibility_filter"],
            "loss_dict": {k: v.detach() for k, v in loss_dict.items()},
            "overflow": out["overflow"],
            "dropped": out["dropped"],
            "num_fragments": out["num_fragments"],
        }
        return total.detach(), aux, (g_params, next(grads))

    def apply_update(self, dyn_state: DynTrainState, g_params: DynParams,
                     new_stats: DensifyStats, iteration) -> DynTrainState:
        """The second half of a dynamic step: one Adam over every dynamic
        leaf (gated by the pose-first warmup), and `new_stats`."""
        cfg = self.cfg
        gate = scene_lr_gate(cfg, iteration)
        new_params, new_opt = adam_update(
            g_params, dyn_state.opt, self.params_of(dyn_state),
            self.lr_tree(iteration),
            update_gate=gate if cfg.scene_lr_delay > 0 else None)
        return dyn_state._replace(
            store=dyn_state.store._replace(params=new_params.gauss),
            motion_coeff=new_params.motion_coeff, net=new_params.net,
            opt=new_opt, stats=new_stats)

    def densify(self, state: DynTrainState, max_screen_size):
        """One densification pass over `state`; returns (state, info). On a
        mesh each gauss shard densifies its slice and `info` is summed."""
        if self.mesh is not None:
            return self._sharded_densify(state, max_screen_size)
        return self.densify_block(state, max_screen_size)

    def densify_block(self, state: DynTrainState, max_screen_size):
        """Densification of the slots `state` holds."""
        cfg = self.cfg
        aux = {
            "mu_params": state.opt.mu.gauss,
            "nu_params": state.opt.nu.gauss,
            "coeff": state.motion_coeff,
            "mu_coeff": state.opt.mu.motion_coeff,
            "nu_coeff": state.opt.nu.motion_coeff,
        }
        new_store, new_aux, new_stats, info = densify_and_prune(
            state.store, aux, state.stats, self.densify_gen,
            max_grad=cfg.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.spatial_lr_scale,
            percent_dense=cfg.percent_dense,
            max_screen_size=max_screen_size,
            isotropic=cfg.isotropic,
            apply_screen_size_prune=cfg.apply_screen_size_prune,
        )
        new_opt = AdamState(
            mu=DynParams(gauss=new_aux["mu_params"],
                         motion_coeff=new_aux["mu_coeff"],
                         net=state.opt.mu.net),
            nu=DynParams(gauss=new_aux["nu_params"],
                         motion_coeff=new_aux["nu_coeff"],
                         net=state.opt.nu.net),
            count=state.opt.count,
        )
        return state._replace(store=new_store, motion_coeff=new_aux["coeff"],
                              opt=new_opt, stats=new_stats), info

    def maybe_densify(self, iteration: int):
        """Densify on the schedule; returns the DensifyInfo or None."""
        if not densify_due(self.cfg, iteration):
            return None
        self.state, info = self.densify(
            self.state, screen_size_threshold(self.cfg, iteration))
        return info

    def state_dict(self, iteration: int) -> dict[str, Any]:
        """Checkpoint payload in the JAX package's layout."""
        sd = {
            "iteration": iteration,
            "active_sh_degree": self.active_sh_degree,
            "model": G.to_state_dict(self.state.store),
            "optim": {"adam": self.state.opt, "stats": self.state.stats},
            "spatial_lr_scale": self.spatial_lr_scale,
        }
        sd["model"]["_motion_coeff"] = self.state.motion_coeff
        sd["model"]["_deform_network"] = self.state.net
        sd["model"]["_timestep"] = self.state.store.time
        return sd
