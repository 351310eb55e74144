"""Static 3DGS trainer. Port of `rodygs_tpu/train/trainer_static.py`
(`StaticTrainerConfig`, `FrameBatch`, `EscalationPoller`, `scene_lr_gate`,
`ThreeDGSTrainer`: the step, densification and the opacity reset, the SH
ramp, `state_dict`).

One iteration: pose-differentiable render through the compact path, the
MultiLoss, gradients over the Gaussian params, the camera poses and the
`means2d` offset (densification statistic), Adam (eps 1e-15) for the
Gaussians with the exponential xyz schedule, Adam for the poses (with
`camera_sparse_adam`, a row-masked Adam that steps only the batch frame's
pose row), and the densify-stat accumulation; then densification and the opacity reset on
their schedules. PyTorch runs eagerly, so there is no step variant to
compile: a fragment-capacity change just allocates at the new size on the
next render.

Randomness (the local Pearson boxes, the split samples) comes from one
`torch.Generator` per trainer on its device, seeded by the caller.

Multi-device (`mesh=`, parallel/mesh.py): the step and densification are
parallel/sharded.py's; the batch is stacked over the data axis
(`sharded.stack_batches`). With a gauss axis the store is interleaved
(`G.shard_interleave`) and this rank keeps only its capacity block of the
store, the Adam moments and the statistics; `capacity()` is the global
capacity, `global_state()` gathers the blocks (a collective: every rank
calls it), and the split samples come from a generator seeded per gauss
shard, while the loss's draws stay identical on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models import gaussians as G
from ..ops.schedules import expon_lr
from ..render.camera import Camera
from ..render.compact import (BAND_KEEP_MARGIN, bands_decision, bands_viable,
                              escalation_poll_due, fit_capacity,
                              fragment_capacity, join_profile,
                              profile_for_demand, split_profile)
from ..render.rasterize import render
from ..utils.platform import resolve_device
from ..utils.profiling import count, host_read, span
from .densify import (DensifyStats, accumulate_stats, densify_and_prune,
                      init_stats, reset_opacity)
from .losses import MultiLoss
from .optim import (AdamState, CameraPoses, adam_init, adam_update,
                    camera_lr_tree, sparse_row_adam_init,
                    sparse_row_adam_update)


@dataclasses.dataclass(frozen=True)
class StaticTrainerConfig:
    """Hyperparameters (defaults = the JAX package's, which follow
    `configs/train/train_kubric_mrig.yaml`)."""

    num_iterations: int = 20000
    position_lr_init: float = 0.00016
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 20000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 5_000_000
    densify_from_iter: int = 500
    densify_until_iter: int = 20000
    densify_grad_threshold: float = 0.0002
    apply_screen_size_prune: bool = False
    camera_rotation_lr: float = 1e-5
    camera_translation_lr: float = 1e-6
    camera_lr_warmup: int = 0
    camera_total_steps: int = 20000
    scene_lr_delay: int = 0
    camera_sparse_adam: bool = False
    sh_degree: int = 3
    isotropic: bool = False
    image_width: int = 256
    image_height: int = 256
    max_fragments: int | None = None


class FrameBatch(NamedTuple):
    """One training view (tensors on the trainer's device)."""

    gt_image: torch.Tensor              # [H, W, 3]
    gt_depth: torch.Tensor | None       # [H, W]
    motion_mask: torch.Tensor | None    # [H, W]
    frame_idx: int                      # selects the pose row
    time: torch.Tensor                  # [] float
    fovx: torch.Tensor                  # [] float
    fovy: torch.Tensor                  # [] float


class StaticTrainState(NamedTuple):
    store: G.GaussianStore
    opt: AdamState                     # over GaussianParams
    stats: DensifyStats
    poses: CameraPoses
    cam_opt: AdamState


def init_static_state(store: G.GaussianStore, poses: CameraPoses,
                      camera_sparse_adam: bool = False) -> StaticTrainState:
    """The state before step 1; `camera_sparse_adam` gives the camera Adam
    a [F] step count (optim.sparse_row_adam_init)."""
    return StaticTrainState(
        store=store,
        opt=adam_init(store.params),
        stats=init_stats(G.capacity_of(store), device=store.alive.device),
        poses=poses,
        cam_opt=(sparse_row_adam_init(poses, poses.q_c2w.shape[0])
                 if camera_sparse_adam else adam_init(poses)),
    )


def make_camera_from_poses(poses: CameraPoses, batch: FrameBatch) -> Camera:
    return Camera(q_c2w=poses.q_c2w[batch.frame_idx],
                  t_c2w=poses.t_c2w[batch.frame_idx],
                  fovx=batch.fovx, fovy=batch.fovy, time=batch.time)


def scene_lr_gate(cfg: StaticTrainerConfig, iteration):
    """0.0 during the pose-first warmup, 1.0 after."""
    if cfg.scene_lr_delay <= 0:
        return 1.0
    return 0.0 if float(iteration) <= cfg.scene_lr_delay else 1.0


def _param_lr_tree(cfg: StaticTrainerConfig, iteration, spatial_lr_scale):
    """The six named param-group LRs, xyz on its schedule, all gated by the
    pose-first warmup."""
    xyz_lr = expon_lr(
        iteration,
        cfg.position_lr_init * spatial_lr_scale,
        cfg.position_lr_final * spatial_lr_scale,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    )
    gate = scene_lr_gate(cfg, iteration)
    return G.GaussianParams(
        xyz=xyz_lr * gate,
        features_dc=cfg.feature_lr * gate,
        features_rest=cfg.feature_lr / 20.0 * gate,
        scaling=cfg.scaling_lr * gate,
        rotation=cfg.rotation_lr * gate,
        opacity=cfg.opacity_lr * gate,
    )


def densify_due(cfg: StaticTrainerConfig, iteration: int) -> bool:
    """Whether densification runs at `iteration`."""
    return (iteration < cfg.densify_until_iter
            and cfg.densification_interval != 0
            and iteration > cfg.densify_from_iter
            and iteration % cfg.densification_interval == 0)


def screen_size_threshold(cfg: StaticTrainerConfig, iteration: int):
    """The screen-size prune threshold of a densification at `iteration`:
    20 pixels once past the first opacity reset, else none."""
    return 20.0 if iteration > cfg.opacity_reset_interval else None


def static_loss_and_grads(cfg: StaticTrainerConfig, loss: MultiLoss,
                          gen: torch.Generator, state: StaticTrainState,
                          batch: FrameBatch, active, sh_degree: int,
                          fragment_profile="lean", tile_axis=None,
                          gauss_axis=None, loss_scale: float = 1.0):
    """The first half of a static step: the loss, aux outputs and the
    gradients (params, poses, `means2d` offset) of one view. On a mesh
    (parallel/sharded.py) `state` is this rank's gauss block, the render
    splits over `tile_axis` / `gauss_axis`, `radii` / `visible` cover the
    gathered set, and the differentiated loss is `total * loss_scale`."""
    params = type(state.store.params)(
        *[p.detach().requires_grad_(True) for p in state.store.params])
    poses = CameraPoses(*[p.detach().requires_grad_(True)
                          for p in state.poses])
    alive = state.store.alive
    offset = torch.zeros((2, G.capacity_of(state.store)),
                         device=alive.device, requires_grad=True)
    out = render(
        params.xyz, G.get_features(params), G.get_opacity(params),
        G.get_scaling(params, cfg.isotropic), params.rotation,
        make_camera_from_poses(poses, batch), sh_degree, cfg.image_width,
        cfg.image_height, alive=alive, means2d_offset=offset,
        max_fragments=cfg.max_fragments, fragment_profile=fragment_profile,
        include_normal=loss.uses_normal, tile_axis=tile_axis,
        gauss_axis=gauss_axis)
    ctx = {
        "pred_img": out["rendered_image"],
        "gt_img": batch.gt_image,
        "pred_depth": out["rendered_depth"],
        "gt_depth": batch.gt_depth,
        "pred_normal": out["rendered_normal"],
        "motion_mask": batch.motion_mask,
        "alive": alive,
        "rng": gen,
    }
    total, loss_dict = loss(ctx, active)
    leaves = [*params, *poses, offset]
    with span("backward"):
        grads = torch.autograd.grad(total * loss_scale, leaves,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    n_p = len(params)
    g_params = type(params)(*grads[:n_p])
    g_poses = CameraPoses(*grads[n_p:n_p + 2])
    aux = {
        "radii": out["radii"],
        "visible": out["visibility_filter"],
        "loss_dict": {k: v.detach() for k, v in loss_dict.items()},
        "overflow": out["overflow"],
        "dropped": out["dropped"],
        "num_fragments": out["num_fragments"],
    }
    return total.detach(), aux, (g_params, g_poses, grads[-1])


def apply_static_update(cfg: StaticTrainerConfig, spatial_lr_scale: float,
                        state: StaticTrainState, g_params, g_poses,
                        new_stats: DensifyStats, iteration,
                        frame_idx) -> StaticTrainState:
    """The second half of a static step: Adam for the Gaussians and the
    poses (with `camera_sparse_adam` only the rows of `frame_idx`, an int
    or a stacked batch's tuple, advance, so round-robin frames step like an
    independent Adam per camera) and `new_stats`, except while the
    pose-first warmup freezes the scene (frozen-scene statistics would
    bias the first densification)."""
    gate = scene_lr_gate(cfg, iteration)
    new_params, new_opt = adam_update(
        g_params, state.opt, state.store.params,
        _param_lr_tree(cfg, iteration, spatial_lr_scale),
        update_gate=gate if cfg.scene_lr_delay > 0 else None)
    cam_lrs = camera_lr_tree(
        iteration, cfg.camera_rotation_lr, cfg.camera_translation_lr,
        cfg.camera_lr_warmup, cfg.camera_total_steps)
    if cfg.camera_sparse_adam:
        q = state.poses.q_c2w
        row_mask = torch.zeros((q.shape[0],), dtype=torch.bool,
                               device=q.device)
        row_mask[torch.as_tensor(frame_idx, device=q.device)] = True
        new_poses, new_cam_opt = sparse_row_adam_update(
            g_poses, state.cam_opt, state.poses, cam_lrs, row_mask)
    else:
        new_poses, new_cam_opt = adam_update(
            g_poses, state.cam_opt, state.poses, cam_lrs)
    if cfg.scene_lr_delay > 0 and gate == 0.0:
        new_stats = state.stats
    return StaticTrainState(
        store=state.store._replace(params=new_params), opt=new_opt,
        stats=new_stats, poses=new_poses, cam_opt=new_cam_opt)


class EscalationPoller:
    """Demand-driven fragment-capacity escalation and shrinking with
    deferred host reads; the logic is the JAX package's, unchanged (see its
    docstring). On a poll iteration it acts on the metrics saved at the
    previous poll, so steady state never waits on the step just enqueued;
    the first poll (iteration 5) fits the capacity to the observed demand
    at once."""

    def __init__(self, allow_shrink: bool = True):
        self._probe = None
        self._shrink_fit = None
        self._bands_pending = None
        self._initial_fit_pending = True
        self.allow_shrink = allow_shrink

    def _fit_with_bands(self, capacity: int, demand: int):
        fit = fit_capacity(capacity, demand)
        return fit, bands_decision(capacity, fit, demand)

    @span("poller")
    def poll(self, iteration: int, metrics: dict, capacity: int, profile):
        """Returns the new fragment profile, or None."""
        new = self._poll(iteration, metrics, capacity, profile)
        if new is not None:
            count("escalations", 1)
        return new

    def _poll(self, iteration: int, metrics: dict, capacity: int, profile):
        if not escalation_poll_due(iteration):
            return None
        probe = self._probe if self._probe is not None else metrics
        self._probe = metrics
        prof, bands = split_profile(profile)
        cur = fragment_capacity(capacity, prof)
        with host_read():
            demand = int(probe["num_fragments"])
        with host_read():
            overflow = bool(probe["overflow"])
        if overflow:
            self._shrink_fit = None
            self._bands_pending = None
            self._initial_fit_pending = False
            if bands > 1:
                for b in range(bands - 1, 0, -1):
                    if bands_viable(capacity, cur, demand, b):
                        self._probe = None
                        return join_profile(prof, b)
            wider = profile_for_demand(capacity, demand, prof, bands=bands)
            if wider is None:
                return None
            self._probe = None
            wcap = fragment_capacity(capacity, wider)
            return join_profile(wider,
                                bands_decision(capacity, wcap, demand))
        if not self.allow_shrink:
            return None
        fit, fit_bands = self._fit_with_bands(capacity, demand)
        if self._initial_fit_pending:
            self._initial_fit_pending = False
            if fit * 5 // 4 <= cur:
                self._probe = None
                return join_profile(fit, fit_bands)
            return None
        if iteration <= 100:
            return None
        if fit * 5 // 4 <= cur:
            prev_fit, self._shrink_fit = self._shrink_fit, fit
            if prev_fit is None:
                return None
            self._probe = None
            self._shrink_fit = None
            fit = max(fit, prev_fit)
            return join_profile(fit, bands_decision(capacity, fit, demand))
        self._shrink_fit = None
        if not bands_viable(capacity, cur, demand, bands):
            self._probe = None
            self._bands_pending = None
            return join_profile(
                prof, bands_decision(capacity, cur, demand,
                                     margin=BAND_KEEP_MARGIN))
        want_b = bands_decision(capacity, cur, demand)
        if want_b <= bands:
            self._bands_pending = None
            return None
        prev, self._bands_pending = self._bands_pending, want_b
        if prev != want_b:
            return None
        self._probe = None
        self._bands_pending = None
        return join_profile(prof, want_b)


class ThreeDGSTrainer:
    """Host-side orchestration of the static train step on one device."""

    def __init__(self, cfg: StaticTrainerConfig, loss: MultiLoss,
                 store: G.GaussianStore, poses: CameraPoses,
                 spatial_lr_scale: float, device=None, seed: int = 0,
                 mesh=None):
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.cfg = cfg
        self.loss = loss
        self.spatial_lr_scale = float(spatial_lr_scale)
        move = lambda tree: type(tree)(*[x.to(self.device) for x in tree])
        store = store._replace(params=move(store.params),
                               alive=store.alive.to(self.device),
                               time=store.time.to(self.device),
                               time_ind=store.time_ind.to(self.device))
        n_gauss = 1 if mesh is None else mesh.shape["gauss"]
        if n_gauss > 1:
            # round-robin the alive slots so per-shard densification starts
            # balanced (parallel/sharded.make_sharded_densify)
            store = G.shard_interleave(store, n_gauss)
        self.state = init_static_state(store, move(poses),
                                       cfg.camera_sparse_adam)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.densify_gen = self.gen
        self.active_sh_degree = 0
        self.fragment_profile: str | int = "lean"
        self._escalation = EscalationPoller()
        if mesh is not None:
            from ..parallel import sharded

            if n_gauss > 1:
                self.state = sharded.static_state_block(self.state, mesh)
                self.densify_gen = torch.Generator(
                    device=self.device).manual_seed(
                        sharded.fold_in_seed(seed, mesh.coords["gauss"]))
            self._sharded_step = sharded.make_sharded_static_step(
                cfg, loss, mesh, self.spatial_lr_scale, self.gen)
            self._sharded_densify = sharded.make_sharded_densify(
                self.densify_block, mesh)

    def capacity(self) -> int:
        """The global capacity (every gauss block together)."""
        n = 1 if self.mesh is None else self.mesh.shape["gauss"]
        return G.capacity_of(self.state.store) * n

    def global_state(self) -> StaticTrainState:
        """The state in the global layout (gathers the gauss blocks: on a
        mesh every rank must call it)."""
        if self.mesh is None or self.mesh.shape["gauss"] == 1:
            return self.state
        from ..parallel.sharded import static_state_global

        return static_state_global(self.state, self.mesh)

    def loss_and_grads(self, state: StaticTrainState, batch: FrameBatch,
                       active, sh_degree: int, fragment_profile="lean"):
        """Loss, aux outputs and the gradients (params, poses, offset)."""
        return static_loss_and_grads(self.cfg, self.loss, self.gen, state,
                                     batch, active, sh_degree,
                                     fragment_profile)

    def step(self, state: StaticTrainState, batch: FrameBatch, iteration,
             active, sh_degree: int, fragment_profile="lean"):
        """One full step from `state`; returns (new_state, metrics). On a
        mesh `batch` is the stacked batch (sharded.stack_batches)."""
        if self.mesh is not None:
            return self._sharded_step(state, batch, iteration, active,
                                      sh_degree, fragment_profile)
        total, aux, (g_params, g_poses, g_offset) = self.loss_and_grads(
            state, batch, active, sh_degree, fragment_profile)
        with span("optim"):
            new_stats = accumulate_stats(
                state.stats, g_offset, aux["radii"].to(torch.float32),
                aux["visible"])
            new_state = apply_static_update(
                self.cfg, self.spatial_lr_scale, state, g_params, g_poses,
                new_stats, iteration, batch.frame_idx)
        metrics = {"loss": total, "overflow": aux["overflow"],
                   "dropped": aux["dropped"],
                   "num_fragments": aux["num_fragments"],
                   **aux["loss_dict"]}
        return new_state, metrics

    def densify(self, state: StaticTrainState, max_screen_size):
        """One densification pass over `state`; returns (state, info). On a
        mesh each gauss block densifies its own slots and `info` is summed
        over the gauss axis."""
        if self.mesh is not None:
            return self._sharded_densify(state, max_screen_size)
        return self.densify_block(state, max_screen_size)

    def densify_block(self, state: StaticTrainState, max_screen_size):
        """Densification of the slots `state` holds (this rank's block)."""
        cfg = self.cfg
        new_store, new_aux, new_stats, info = densify_and_prune(
            state.store, {"mu_params": state.opt.mu, "nu_params": state.opt.nu},
            state.stats, self.densify_gen,
            max_grad=cfg.densify_grad_threshold,
            min_opacity=0.005,
            extent=self.spatial_lr_scale,
            percent_dense=cfg.percent_dense,
            max_screen_size=max_screen_size,
            isotropic=cfg.isotropic,
            apply_screen_size_prune=cfg.apply_screen_size_prune,
        )
        new_opt = AdamState(mu=new_aux["mu_params"], nu=new_aux["nu_params"],
                            count=state.opt.count)
        return state._replace(store=new_store, opt=new_opt,
                              stats=new_stats), info

    def maybe_ramp_sh(self, iteration: int, start: int = 0, period: int = 1000):
        """`oneupSHdegree` on its schedule: every `period` iterations after
        `start` (the standalone static trainer's 1000 from 0)."""
        if iteration > start and iteration % period == 0:
            self.active_sh_degree = G.sh_degree_up(
                self.active_sh_degree, self.cfg.sh_degree)

    @span("iteration")
    def train_iteration(self, batch: FrameBatch, iteration: int) -> dict:
        active = self.loss.active_set(iteration)
        self.state, metrics = self.step(
            self.state, batch, float(iteration), active,
            self.active_sh_degree, self.fragment_profile)
        wider = self._escalation.poll(
            iteration, metrics, self.capacity(), self.fragment_profile)
        if wider is not None:
            self.fragment_profile = wider
        cfg = self.cfg
        if densify_due(cfg, iteration):
            self.state, metrics["densify"] = self.densify(
                self.state, screen_size_threshold(cfg, iteration))
        if (iteration < cfg.densify_until_iter
                and cfg.opacity_reset_interval != 0
                and iteration % cfg.opacity_reset_interval == 0):
            st = self.state
            store, mu_op, nu_op = reset_opacity(
                st.store, st.opt.mu.opacity, st.opt.nu.opacity)
            self.state = st._replace(store=store, opt=st.opt._replace(
                mu=st.opt.mu._replace(opacity=mu_op),
                nu=st.opt.nu._replace(opacity=nu_op)))
        return metrics

    def state_dict(self, iteration: int) -> dict[str, Any]:
        """Checkpoint payload in the JAX package's layout (global arrays:
        on a mesh every rank must call it)."""
        st = self.global_state()
        return {
            "iteration": iteration,
            "active_sh_degree": self.active_sh_degree,
            "model": G.to_state_dict(st.store),
            "optim": {
                "max_radii2D": st.stats.max_radii2d,
                "xyz_gradient_accum": st.stats.grad_accum,
                "denom": st.stats.denom,
                "adam": st.opt,
            },
            "camera": {"q_c2w": st.poses.q_c2w, "t_c2w": st.poses.t_c2w},
            "spatial_lr_scale": self.spatial_lr_scale,
        }
