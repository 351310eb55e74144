"""Dynamic (motion-basis) Gaussian trainer. Port of
`rodygs_tpu/train/trainer_dynamic.py` (`DynTrainerConfig`, `DynParams`,
`DynTrainState`, `DynTrainer`; the `mesh` branches wait for multi-device).

The static trainer's Gaussian params plus the motion coefficients and the
motion net, one Adam over all of them; densification moves the
coefficients and their moments with their Gaussians. Rendering happens in
the joint trainer (trainer_joint.py), on the static set concatenated with
the deformed dynamic set.

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
from .densify import DensifyStats, densify_and_prune, init_stats
from .losses import MultiLoss
from .optim import AdamState, adam_init, tree_map
from .trainer_static import (StaticTrainerConfig, _param_lr_tree,
                             densify_due, scene_lr_gate, screen_size_threshold)


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
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
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
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
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

    def params(self) -> DynParams:
        return DynParams(gauss=self.state.store.params,
                         motion_coeff=self.state.motion_coeff,
                         net=self.state.net)

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

    def densify(self, state: DynTrainState, max_screen_size):
        """One densification pass over `state`; returns (state, info)."""
        cfg = self.cfg
        aux = {
            "mu_params": state.opt.mu.gauss,
            "nu_params": state.opt.nu.gauss,
            "coeff": state.motion_coeff,
            "mu_coeff": state.opt.mu.motion_coeff,
            "nu_coeff": state.opt.nu.motion_coeff,
        }
        new_store, new_aux, new_stats, info = densify_and_prune(
            state.store, aux, state.stats, self.gen,
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
