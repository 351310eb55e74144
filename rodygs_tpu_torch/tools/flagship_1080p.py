"""Flagship-scale validation of the joint pipeline: 1920x1080, 120,000 static
+ 120,000 dynamic gaussians (`BASELINE.json` configs[4] without the real
dataset). Port of `scripts/flagship_1080p.py`.

    python -m rodygs_tpu_torch.tools.flagship_1080p [--iters 400]
        [--width 1920] [--height 1080] [--n 120000] [--out result.json]
        [--device cpu]

One run exercises:
  * static + dynamic interleaved training (the full RoDyGS iteration) at
    Kubric-MRig scale (`configs/train/train_kubric_mrig.yaml:42,102`),
  * camera-pose optimisation at the reference kubric learning rates,
  * densification and pruning on both models' schedules,
  * the depth-prior losses (global and local Pearson) fed by the GT
    renderer's own depth channel as a synthetic prior,
  * fragment-capacity escalation under real overflow pressure (init
    footprints `--scale_inflate` x the GT's): the run fails if any
    fragment is still dropped at the end,
  * PSNR on a train view and on a held-out pose, and with `--eval_w_align`
    the test-time pose optimisation of that view,
  * with `--pose_noise_*` a noised initial trajectory, recovered by
    training and, with `--pose_prealign`, a coarse-to-fine pre-alignment
    with a loss-gated retry; with `--resume_every` resume snapshots.

The scene, the init clouds, the birth times, the pose noise and the GT
views come from numpy draws of `default_rng(13)` in the JAX script's
order, so both tools build the same scene. The trainers draw from seeded
`torch.Generator`s (the static trainer's seed 1, the dynamic one's 0).

Prints one JSON line with the JAX script's result keys, plus `device` (the
card's name and power limit), `loss_traj` (the mean static and dynamic
loss of each logged window) and `dropped_eval_at_train_profile` (what the
two PSNR renders drop at the trainer's dynamic profile, where the JAX
script renders them; here each escalates until nothing overflows, and
`dropped_eval` is what it drops then); `peak_hbm_gb` is
`torch.cuda.max_memory_allocated`. `--out` also writes it to a file; by
default nothing is written (the JAX script's default `FLAGSHIP_1080P.json`
holds its own runs).

Left out from the JAX script, which needed them only to reach its TPU:
the `RODYGS_FORCE_CPU` switch (`--device cpu` here), the persistent
compile cache (PyTorch compiles nothing per process but the CUDA kernels,
which `rodygs_tpu_torch/_build/` keeps) and the retry loop around
remote-compile failures. `RODYGS_PREALIGN_DEBUG` is gone too: every view's
pre-alignment line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..evalsuite.evaluator import escalated_profile
from ..evalsuite.pose_metrics import PoseEvaluator
from ..evalsuite.pose_opt import PoseOptimizer
from ..models import gaussians as G
from ..ops.image import l2_loss
from ..ops.quaternion import matrix_to_quat, quat_multiply, quat_to_matrix
from ..render.binning import tile_grid
from ..render.camera import Camera, make_camera
from ..render.compact import (build_binning, join_profile, profile_for_demand,
                              split_profile)
from ..render.preprocess import preprocess
from ..render.rasterize import render
from ..train.losses import LossTerm, MultiLoss
from ..train.optim import CameraPoses, adam_init, adam_update
from ..train.trainer_dynamic import DynTrainer, DynTrainerConfig
from ..train.trainer_joint import RoDyGSTrainer
from ..train.trainer_static import (FrameBatch, StaticTrainerConfig,
                                    ThreeDGSTrainer)
from ..utils.platform import device_label, resolve_device

N_FRAMES = 12
FOVX, FOVY = 0.98, 0.60
INIT_NOISE = 0.01              # init cloud: GT centres + N(0, 0.01)
SPATIAL_LR_SCALE = 5.0
STATIC_SEED, DYNAMIC_SEED = 1, 0
HOLDOUT_ANGLE = 0.015          # the held-out pose, between frames 5 and 6
HOLDOUT_FRAME = 5.5
W_ALIGN_LR = 5e-5              # configs/eval/eval_w_align.yaml


def log(msg: str) -> None:
    print(f"[flagship] {msg}", flush=True)


def capacities(n: int) -> tuple[int, int]:
    """(GT store capacity, trainer store capacity: 2x densification
    headroom)."""
    cap_gt = max(1024, 1 << (n - 1).bit_length())
    return cap_gt, 2 * cap_gt


class Scene(NamedTuple):
    width: int
    height: int
    n: int
    draws: dict                   # the numpy draws, by the JAX script's names
    gt_q: np.ndarray              # [F, 4] exact camera poses
    gt_t: np.ndarray              # [F, 3]
    gt_static: G.GaussianStore    # GT stores (trained-like footprints)
    gt_dynamic: G.GaussianStore   # at t = 0; moves with draws["vel"] * t
    static_init: G.GaussianStore  # the trainers' initial stores
    dynamic_init: G.GaussianStore


def _with_scales(store: G.GaussianStore, scales: np.ndarray) -> G.GaussianStore:
    """`store` with log-scales from `scales`, dead slots at 1e-6."""
    cap = G.capacity_of(store)
    pad = np.log(np.pad(scales, ((0, cap - scales.shape[0]), (0, 0)),
                        constant_values=1e-6)).astype(np.float32)
    return store._replace(params=store.params._replace(
        scaling=torch.tensor(pad, device=store.alive.device)))


def make_scene(n: int, rng: np.random.Generator, width: int = 1920,
               height: int = 1080, scale_inflate: float = 2.5,
               device=None) -> Scene:
    """The GT scene and the trainers' init clouds (`scripts/flagship_1080p.py
    :95-131,198-224`): uniform static and dynamic volumes with trained-like
    footprints, a velocity per dynamic gaussian, 12 cameras on a +-0.18 rad
    arc; init clouds = GT centres + noise, the dynamic ones at a birth frame
    each, with GT footprints inflated by `scale_inflate`."""
    dev = resolve_device(device)
    d = {}
    d["sm"] = rng.uniform([-4.0, -2.5, 2.5], [4.0, 2.5, 9.0],
                          size=(n, 3)).astype(np.float32)
    d["s_scales"] = np.exp(rng.uniform(-5.2, -3.8, size=(n, 3))).astype(np.float32)
    d["s_cols"] = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    d["dm0"] = rng.uniform([-2.0, -1.5, 3.0], [2.0, 1.5, 6.0],
                           size=(n, 3)).astype(np.float32)
    d["d_scales"] = np.exp(rng.uniform(-5.2, -4.0, size=(n, 3))).astype(np.float32)
    d["d_cols"] = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    d["vel"] = rng.uniform(-0.25, 0.25, size=(n, 3)).astype(np.float32)
    d["sm_init"] = d["sm"] + rng.normal(0, INIT_NOISE, d["sm"].shape).astype(
        np.float32)
    birth = rng.integers(0, N_FRAMES, size=n)
    d["birth_t"] = (birth / (N_FRAMES - 1)).astype(np.float32)
    d["dm_init"] = (d["dm0"] + d["vel"] * d["birth_t"][:, None]
                    + rng.normal(0, INIT_NOISE, d["dm0"].shape)).astype(np.float32)

    angles = np.linspace(-0.18, 0.18, N_FRAMES)
    gt_q = np.stack([np.array([np.cos(a / 2), 0, np.sin(a / 2), 0], np.float32)
                     for a in angles])
    gt_t = np.stack([np.array([np.sin(a) * 5.0, 0.0, 0.0], np.float32)
                     for a in angles])

    cap_gt, cap_tr = capacities(n)

    def store(xyz, cols, cap, times=None):
        return G.from_point_cloud(xyz, cols, sh_degree=3, capacity=cap,
                                  times=times, device=dev)

    return Scene(
        width=width, height=height, n=n, draws=d, gt_q=gt_q, gt_t=gt_t,
        gt_static=_with_scales(store(d["sm"], d["s_cols"], cap_gt),
                               d["s_scales"]),
        gt_dynamic=_with_scales(store(d["dm0"], d["d_cols"], cap_gt),
                                d["d_scales"]),
        static_init=_with_scales(store(d["sm_init"], d["s_cols"], cap_tr),
                                 d["s_scales"] * scale_inflate),
        dynamic_init=_with_scales(
            store(d["dm_init"], d["d_cols"], cap_tr, times=d["birth_t"]),
            d["d_scales"] * scale_inflate))


def frame_time(i: int) -> float:
    return i / (N_FRAMES - 1)


def frame_camera(scene: Scene, i: int) -> Camera:
    return make_camera(scene.gt_q[i], scene.gt_t[i], FOVX, FOVY,
                       time=frame_time(i), device=scene.gt_static.alive.device)


def holdout_camera(scene: Scene) -> tuple[Camera, float]:
    a = HOLDOUT_ANGLE
    t = HOLDOUT_FRAME / (N_FRAMES - 1)
    cam = make_camera(np.array([np.cos(a / 2), 0, np.sin(a / 2), 0], np.float32),
                      np.array([np.sin(a) * 5.0, 0, 0], np.float32), FOVX, FOVY,
                      time=t, device=scene.gt_static.alive.device)
    return cam, t


def _moved_dynamic_xyz(scene: Scene, t: float) -> torch.Tensor:
    """The GT dynamic centres at time t (the offset formed in numpy, as the
    JAX script forms it)."""
    xyz = scene.gt_dynamic.params.xyz
    off = np.pad(scene.draws["vel"] * t, ((0, xyz.shape[0] - scene.n), (0, 0)))
    return xyz + torch.as_tensor(off, device=xyz.device)


def render_escalating(render_at, n: int, profile, widen):
    """`render_at(profile)`, taken again at `widen(n, demand, profile)` while
    it overflows, until it fits or `widen` has nothing wider (None).
    Returns (the last render, the profiles rendered at, the fragments the
    first render dropped)."""
    profiles = [profile]
    out = render_at(profile)
    first_dropped = int(out["dropped"])
    while bool(out["overflow"]):
        wider = widen(n, int(out["num_fragments"]), profiles[-1])
        if wider is None:
            break
        log(f"render escalation {profiles[-1]} -> {wider} "
            f"({int(out['dropped'])} fragments dropped)")
        profiles.append(wider)
        out = render_at(wider)
    return out, profiles, first_dropped


@torch.no_grad()
def render_gt(scene: Scene, cam: Camera, t: float, profile):
    """The GT static set plus the GT dynamic set moved to time t, rendered
    at `profile` and escalated until nothing overflows, so GT is never
    clipped. Returns (image clipped to [0, 1], depth, profiles tried: the
    last is the one that fitted)."""
    sp, dp = scene.gt_static.params, scene.gt_dynamic.params
    args = [torch.cat(x) for x in (
        (sp.xyz, _moved_dynamic_xyz(scene, t)),
        (G.get_features(sp), G.get_features(dp)),
        (G.get_opacity(sp), G.get_opacity(dp)),
        (G.get_scaling(sp), G.get_scaling(dp)),
        (sp.rotation, dp.rotation))]
    alive = torch.cat([scene.gt_static.alive, scene.gt_dynamic.alive])
    out, profiles, _ = render_escalating(
        lambda p: render(*args, cam, 3, scene.width, scene.height,
                         alive=alive, fragment_profile=p),
        alive.shape[0], profile, profile_for_demand)
    if bool(out["overflow"]):
        raise RuntimeError("GT demand exceeds the capacity cap")
    return (torch.clamp(out["rendered_image"], 0.0, 1.0),
            out["rendered_depth"], profiles)


@torch.no_grad()
def dynamic_mask(scene: Scene, cam: Camera, t: float, profile) -> torch.Tensor:
    """The dynamic GT set's alpha > 0.3 at time t: the synthetic analogue of
    the TAM motion masks Kubric ships."""
    dp = scene.gt_dynamic.params
    out = render(_moved_dynamic_xyz(scene, t), G.get_features(dp),
                 G.get_opacity(dp), G.get_scaling(dp), dp.rotation, cam, 3,
                 scene.width, scene.height, alive=scene.gt_dynamic.alive,
                 fragment_profile=profile)
    return (out["rendered_alpha"] > 0.3).to(torch.float32)


class Frames(NamedTuple):
    images: list       # [H, W, 3] GT images
    depths: list       # [H, W] GT depths (the synthetic depth prior)
    cameras: list
    masks: list        # [H, W] motion masks, or None each


def gt_views(scene: Scene, motion_masks: bool, profile="wide"):
    """The 12 GT views (and masks); returns (Frames, the GT profile)."""
    frames = Frames([], [], [], [])
    for i in range(N_FRAMES):
        cam = frame_camera(scene, i)
        img, depth, tried = render_gt(scene, cam, frame_time(i), profile)
        profile = tried[-1]
        frames.images.append(img)
        frames.depths.append(depth)
        frames.cameras.append(cam)
        frames.masks.append(dynamic_mask(scene, cam, frame_time(i), profile)
                            if motion_masks else None)
    return frames, profile


def perturb_poses(gt_q: np.ndarray, gt_t: np.ndarray, rng: np.random.Generator,
                  rot_deg: float, trans_sigma: float):
    """A fixed-magnitude rotation about a random axis per camera and
    N(0, trans_sigma) on its translation (a MASt3R-like imperfect
    trajectory). Returns (q [F, 4], t [F, 3]) float32."""
    f = gt_q.shape[0]
    half = np.deg2rad(rot_deg) / 2.0
    axes = rng.normal(size=(f, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    dq = np.concatenate([np.full((f, 1), np.cos(half)), np.sin(half) * axes],
                        axis=1).astype(np.float32)
    init_q = quat_multiply(torch.from_numpy(dq),
                           torch.from_numpy(np.ascontiguousarray(gt_q))).numpy()
    init_t = (gt_t + rng.normal(0, trans_sigma, gt_t.shape)).astype(np.float32)
    return init_q, init_t


def c2w_mats(qs: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """[F, 4, 4] float64 camera-to-world matrices."""
    mats = np.tile(np.eye(4, dtype=np.float64), (len(qs), 1, 1))
    mats[:, :3, :3] = quat_to_matrix(
        torch.tensor(np.asarray(qs, np.float32))).numpy()
    mats[:, :3, 3] = np.asarray(ts)
    return mats


def pose_scores(gt_q, gt_t, est_q, est_t) -> dict:
    s = PoseEvaluator().get_score(c2w_mats(gt_q, gt_t), c2w_mats(est_q, est_t))
    return {k: round(float(v), 6) for k, v in s.items() if k != "aligned"}


# --------------------------------------------------------------------------
# pose pre-alignment
# --------------------------------------------------------------------------


def pool(img: torch.Tensor, f: int) -> torch.Tensor:
    """Average-pool [H, W(, C)] by f on both axes."""
    if f == 1:
        return img
    hh, ww = img.shape[0] // f, img.shape[1] // f
    return img.reshape(hh, f, ww, f, *img.shape[2:]).mean((1, 3))


def _static_render(store: G.GaussianStore, q, t, width, height):
    """The frozen static set through the pose-only render path."""
    cam = make_camera(q, t, FOVX, FOVY, 0.0, device=q.device)
    out = render(*G.active_arrays(store)[:5], cam, 3, width, height,
                 alive=store.alive, fragment_profile="wide",
                 include_normal=False, pose_grad_only=True)
    return torch.clamp(out["rendered_image"], 0.0, 1.0)


def prealign_level(store: G.GaussianStore, q0, t0, gt, mask, factor: int,
                   steps: int, lr: float, width: int, height: int):
    """`steps` Adam steps on (q, t) of the masked L1 between the render of
    the frozen `store` and `gt`, both average-pooled by `factor` (a pyramid
    level: rendering at a lower resolution would shrink the splats to dust
    while the pooled GT stays smooth). Pixels the pooled motion mask touches
    are left out. Returns (q, t, the loss of every step [steps], the first
    step's gradients (gq, gt))."""
    gt_l = pool(gt, factor)
    keep = 1.0 - (pool(mask, factor) > 0.25 / (factor * factor)).to(
        torch.float32)
    pose = (q0, t0)
    opt = adam_init(pose)
    losses, first = [], None
    for _ in range(steps):
        q, t = (x.detach().requires_grad_(True) for x in pose)
        pred = pool(_static_render(store, q, t, width, height), factor)
        loss = torch.mean(torch.abs((pred - gt_l) * keep[..., None]))
        grads = torch.autograd.grad(loss, (q, t))
        first = grads if first is None else first
        losses.append(loss.detach())
        pose, opt = adam_update(grads, opt, (q.detach(), t.detach()), lr)
    return (pose[0], pose[1],
            torch.stack(losses) if losses else torch.zeros(0), first)


@torch.no_grad()
def prealign_eval_loss(store, q, t, gt, mask, width, height) -> float:
    keep = 1.0 - (mask > 0.0).to(torch.float32)
    pred = _static_render(store, q, t, width, height)
    return float(torch.mean(torch.abs((pred - gt) * keep[..., None])))


def pose_prealign(store: G.GaussianStore, init_q: np.ndarray,
                  init_t: np.ndarray, frames: Frames, steps: int,
                  retry_thresh: float, width: int, height: int):
    """Per-view coarse-to-fine pose pre-alignment against the frozen init
    scene (the test-time pose optimiser's machinery at train init): pool 4
    for `steps` at lr 4e-3, then full resolution for `steps` at 1e-3. Views
    that end with a clearly elevated loss (above `retry_thresh` and 1.8x
    the 25th percentile) run the ladder again from the optimised poses of
    their two nearest converged views (by init translation) and keep the
    lower loss. Returns (q [F, 4], t [F, 3], info)."""
    dev = store.alive.device
    levels = [(4, steps, 4e-3), (1, steps, 1e-3)]

    def mask_for(i):
        m = frames.masks[i]
        return m if m is not None else torch.zeros(
            frames.images[i].shape[:2], device=dev)

    def run_ladder(i, q, t):
        q = torch.as_tensor(q, dtype=torch.float32, device=dev)
        t = torch.as_tensor(t, dtype=torch.float32, device=dev)
        for f, n_steps, lr in levels:
            q, t, _, _ = prealign_level(store, q, t, frames.images[i],
                                        mask_for(i), f, n_steps, lr, width,
                                        height)
        return (q.cpu().numpy(), t.cpu().numpy(),
                prealign_eval_loss(store, q, t, frames.images[i], mask_for(i),
                                   width, height))

    out_q, out_t, out_loss = [], [], []
    t0 = time.time()
    for i in range(N_FRAMES):
        loss0 = prealign_eval_loss(
            store, torch.tensor(init_q[i], device=dev),
            torch.tensor(init_t[i], device=dev), frames.images[i],
            mask_for(i), width, height)
        q, t, loss = run_ladder(i, init_q[i], init_t[i])
        log(f"prealign view {i}: max|dq|={np.abs(init_q[i] - q).max():.4f} "
            f"max|dt|={np.abs(init_t[i] - t).max():.4f} loss "
            f"{loss0:.4f} -> {loss:.4f}")
        out_q.append(q)
        out_t.append(t)
        out_loss.append(loss)

    losses = np.asarray(out_loss)
    thresh = max(retry_thresh, 1.8 * float(np.percentile(losses, 25)))
    diverged = np.where(losses > thresh)[0]
    converged = np.where(losses <= thresh)[0]
    retries = {"thresh": round(thresh, 5), "diverged": diverged.tolist(),
               "rescued": []}
    if len(diverged) and len(converged):
        for i in diverged:
            d = np.linalg.norm(init_t[converged] - init_t[i], axis=1)
            nbrs = converged[np.argsort(d)[:2]]
            for j in nbrs:
                q, t, loss = run_ladder(i, out_q[j], out_t[j])
                if loss < out_loss[i]:
                    out_q[i], out_t[i], out_loss[i] = q, t, loss
                if loss <= thresh:
                    retries["rescued"].append(int(i))
                    break
            log(f"prealign retry view {i}: from {nbrs.tolist()} -> "
                f"loss={out_loss[i]:.4f}")
    dt = time.time() - t0
    return (np.stack(out_q), np.stack(out_t),
            {"per_view_s": round(dt / N_FRAMES, 3), "steps_per_level": steps,
             "pool_factors": [lv[0] for lv in levels],
             "view_losses": [round(v, 5) for v in out_loss],
             "retry": retries})


# --------------------------------------------------------------------------
# the joint trainer
# --------------------------------------------------------------------------


def build_joint(scene: Scene, poses: CameraPoses, args,
                device=None) -> RoDyGSTrainer:
    """The losses and configs of the flagship run (reference kubric
    hyperparameters at the scene's size). With `args.motion_masks` the
    static stage's losses leave the dynamic region out (mode "static", the
    reference's masked-loss semantics): un-modelled dynamic content would
    otherwise bias the pose gradients, which only the static stage makes."""
    s_mode = (("mode", "static"),) if args.motion_masks else ()
    static_loss = MultiLoss([
        LossTerm("d_ssim", 0.2, "SSIMLoss", params=s_mode),
        LossTerm("l1", 0.8, "L1Loss", params=s_mode),
        LossTerm("global_pearson_depth", 0.05, "GlobalPearsonDepthLoss",
                 params=s_mode),
        LossTerm("local_pearson_depth", 0.15, "LocalPearsonDepthLoss",
                 params=(("box_p", 128), ("p_corr", 0.5)) + s_mode),
    ])
    dyn_loss = MultiLoss([
        LossTerm("d_ssim", 0.2, "SSIMLoss"),
        LossTerm("l1", 0.8, "L1Loss"),
        LossTerm("motion_l1_reg", 0.01, "MotionL1Loss"),
        LossTerm("motion_sparsity", 0.002, "MotionSparsityLoss"),
        LossTerm("global_pearson_depth", 0.05, "GlobalPearsonDepthLoss"),
        LossTerm("local_pearson_depth", 0.15, "LocalPearsonDepthLoss",
                 params=(("box_p", 128), ("p_corr", 0.5))),
        LossTerm("rigidity", 0.5, "RigidityLoss", freq=5,
                 params=(("mode", ("distance_preserving", "surface")),
                         ("K", 8))),
        LossTerm("motion_basis_reg", 0.1, "MotionBasisRegularizaiton",
                 params=(("transl_degree", 0), ("rot_degree", 0),
                         ("freq_div_mode", "cum_exponential"))),
    ])
    until_s, until_d = densify_until(args)
    common = dict(
        image_width=scene.width, image_height=scene.height, sh_degree=3,
        position_lr_max_steps=args.iters,
        densification_interval=100, densify_from_iter=args.densify_from,
        densify_grad_threshold=0.0002, percent_dense=0.01,
        camera_lr_warmup=0,
        camera_total_steps=(args.camera_total_steps
                            if args.camera_total_steps > 0 else args.iters),
        scene_lr_delay=args.scene_lr_delay)
    s_cfg = StaticTrainerConfig(
        camera_rotation_lr=args.camera_rotation_lr,
        camera_translation_lr=args.camera_translation_lr,
        camera_sparse_adam=args.camera_sparse_adam,
        densify_until_iter=until_s, **common)
    d_cfg = DynTrainerConfig(
        deform_netwidth=128, deform_t_emb_multires=26, num_basis=16,
        inverse_motion=True, deform_lr_max_steps=args.iters,
        camera_rotation_lr=0.0, camera_translation_lr=0.0,
        densify_until_iter=until_d, **common)
    st = ThreeDGSTrainer(s_cfg, static_loss, scene.static_init, poses,
                         SPATIAL_LR_SCALE, device=device, seed=STATIC_SEED)
    dt = DynTrainer(d_cfg, dyn_loss, scene.dynamic_init, SPATIAL_LR_SCALE,
                    seed=DYNAMIC_SEED, device=device)
    return RoDyGSTrainer(st, dt, sh_up_start_iteration=args.sh_up_start)


def densify_until(args) -> tuple[int, int]:
    return ((args.densify_until_static if args.densify_until_static >= 0
             else args.iters),
            (args.densify_until_dynamic if args.densify_until_dynamic >= 0
             else args.iters))


def batch_for(frames: Frames, i: int) -> FrameBatch:
    dev = frames.images[i].device
    return FrameBatch(
        gt_image=frames.images[i], gt_depth=frames.depths[i],
        motion_mask=frames.masks[i], frame_idx=i,
        time=torch.tensor(frame_time(i), dtype=torch.float32, device=dev),
        fovx=torch.tensor(FOVX, dtype=torch.float32, device=dev),
        fovy=torch.tensor(FOVY, dtype=torch.float32, device=dev))


def _rss_mb() -> int:
    """Resident host memory of this process, MB."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f
                    if line.startswith("VmRSS")) // 1024


def train(joint: RoDyGSTrainer, frames: Frames, args, scene: Scene,
          pose_noise: dict) -> dict:
    """Joint iterations 1..args.iters (frame (it - 1) % 12), resumed from
    `args.state_dir` when `args.resume_every` is set and a snapshot is
    there. Every `args.log_every` iterations: the window's ms per
    iteration, the drops, the alive counts, the host RSS, the ATE of the
    poses (with pose noise) and the window's mean losses. Every escalation
    of a fragment profile is printed. Returns the run's history, with
    "iteration_profiles": the (static, dynamic) profiles each iteration of
    this call rendered at."""
    st, dyn = joint.static, joint.dynamic
    hist = {"window_times": [], "escalations": [], "alive_traj": [],
            "rss_traj": [], "loss_traj": [], "train_s_prev": 0.0,
            "resumed_from": None, "pose_noise": pose_noise,
            "iteration_profiles": []}
    start_iter = 1
    state_dir = Path(args.state_dir)
    resume_ckpt = state_dir / "resume.ckpt"
    sidecar_path = state_dir / "resume_sidecar.json"
    if args.resume_every and resume_ckpt.exists():
        start_iter = joint.load_resume(resume_ckpt)
        side = json.loads(sidecar_path.read_text())
        if side.get("iteration", start_iter - 1) != start_iter - 1:
            # a crash between the sidecar's and the checkpoint's publish:
            # the trainer state rules, the history is advisory
            log(f"WARNING: sidecar stamped iter {side.get('iteration')} vs "
                f"ckpt iter {start_iter - 1}; run-history stats may be one "
                "snapshot off")
        for k in ("window_times", "escalations", "alive_traj", "rss_traj",
                  "loss_traj"):
            hist[k] = side.get(k, [])
        hist["train_s_prev"] = side["train_s"]
        if side.get("pose_noise"):
            hist["pose_noise"] = side["pose_noise"]
        # JSON turns (profile, bands) tuples into lists
        st.fragment_profile = join_profile(*split_profile(side["profiles"][0]))
        joint.dyn_fragment_profile = join_profile(
            *split_profile(side["profiles"][1]))
        hist["resumed_from"] = start_iter - 1
        log(f"RESUMED at iter {start_iter} (profiles={side['profiles']})")

    t_train0 = time.time()

    def save_snapshot(it):
        # both files written aside, the sidecar (stamped with `it`)
        # published before the checkpoint: a crash between the two leaves
        # ckpt(N - 1) + sidecar(N), which the stamp check above detects
        state_dir.mkdir(parents=True, exist_ok=True)
        tmp = state_dir / "resume.ckpt.tmp"
        joint.save_resume(tmp, it)
        side_tmp = state_dir / "resume_sidecar.json.tmp"
        side_tmp.write_text(json.dumps({
            "iteration": it,
            **{k: hist[k] for k in ("window_times", "escalations",
                                    "alive_traj", "rss_traj", "loss_traj")},
            "train_s": hist["train_s_prev"] + time.time() - t_train0,
            "pose_noise": hist["pose_noise"],
            "profiles": [st.fragment_profile, joint.dyn_fragment_profile]}))
        os.replace(side_tmp, sidecar_path)
        os.replace(tmp, resume_ckpt)

    t_win = time.time()
    win_iters = 0
    win_loss = torch.zeros(2, device=st.device)
    profile_before = (st.fragment_profile, joint.dyn_fragment_profile)
    dropped_last = (0, 0)
    batches = [batch_for(frames, i) for i in range(N_FRAMES)]
    for it in range(start_iter, args.iters + 1):
        b = batches[(it - 1) % N_FRAMES]
        hist["iteration_profiles"].append(profile_before)
        m = joint.train_iteration(b, b, it)
        win_iters += 1
        win_loss += torch.stack([m["static"]["loss"].detach(),
                                 m["dynamic"]["loss"].detach()])
        prof = (st.fragment_profile, joint.dyn_fragment_profile)
        if prof != profile_before:
            hist["escalations"].append({"iter": it, "profiles": list(prof)})
            log(f"iter {it}: profile escalation -> {prof}")
            profile_before = prof
        if it % args.log_every == 0 or it == args.iters:
            losses = (win_loss / win_iters).tolist()
            dt_win = time.time() - t_win
            hist["window_times"].append(round(dt_win / win_iters, 4))
            hist["loss_traj"].append([it, losses[0], losses[1]])
            dropped_last = (int(m["static"]["dropped"]),
                            int(m["dynamic"]["dropped"]))
            hist["alive_traj"].append([it, int(G.num_alive(st.state.store)),
                                       int(G.num_alive(dyn.state.store))])
            # the flat-RSS criterion of long runs: host-side leaks show here
            hist["rss_traj"].append([it, _rss_mb()])
            if hist["pose_noise"]:
                s = pose_scores(scene.gt_q, scene.gt_t,
                                st.state.poses.q_c2w.cpu().numpy(),
                                st.state.poses.t_c2w.cpu().numpy())
                hist["pose_noise"].setdefault("ate_traj", []).append(
                    [it, s["ATE"]])
            log(f"iter {it}: static loss={float(m['static']['loss']):.4f} "
                f"dyn loss={float(m['dynamic']['loss']):.4f} (window means "
                f"{losses[0]:.4f} / {losses[1]:.4f}) "
                f"{dt_win / win_iters * 1e3:.0f} ms/it dropped={dropped_last} "
                f"profiles={prof} alive={hist['alive_traj'][-1][1:]}")
            t_win = time.time()
            win_iters = 0
            win_loss.zero_()
        if args.resume_every and it % args.resume_every == 0:
            t_snap = time.time()
            save_snapshot(it)
            log(f"iter {it}: resume snapshot saved "
                f"({time.time() - t_snap:.1f}s)")
            t_win += time.time() - t_snap  # keep window times honest
    hist["train_s"] = hist["train_s_prev"] + (time.time() - t_train0)
    hist["dropped_last"] = dropped_last
    return hist


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------


@torch.no_grad()
def concatenated(joint: RoDyGSTrainer, t: float):
    """The render arguments of the static set and the dynamic set deformed
    to time t: (means, shs, opacity, scaling, rotation, alive)."""
    st, dyn = joint.static.state, joint.dynamic.state
    sp = st.store.params
    params = joint.dynamic.params()
    transl, rot_delta = joint.dynamic.deformation(
        params, torch.tensor(t, dtype=torch.float32, device=sp.xyz.device),
        dyn.store.time_ind)
    gp = params.gauss
    return (torch.cat([sp.xyz, gp.xyz + transl]),
            torch.cat([G.get_features(sp), G.get_features(gp)]),
            torch.cat([G.get_opacity(sp), G.get_opacity(gp)]),
            torch.cat([G.get_scaling(sp), G.get_scaling(gp)]),
            torch.cat([sp.rotation, G.get_rotation(gp) + rot_delta]),
            torch.cat([st.store.alive, dyn.store.alive]))


@torch.no_grad()
def mse_psnr(joint: RoDyGSTrainer, scene: Scene, cam: Camera, gt, t: float,
             profile):
    """(MSE, PSNR, dropped fragments, the profile rendered at, the fragments
    dropped at `profile`) of the trained scene's render, from `profile`
    escalated while it overflows (`evalsuite.evaluator.escalated_profile`),
    so no reported PSNR is of a clipped render unless no profile can hold
    more. The JAX script renders once at the trainer's dynamic profile,
    which the poller last fitted to the demand of the frames trained just
    before, not to this view: the last value is what it would drop."""
    *arrays, alive = concatenated(joint, t)
    out, profiles, dropped_at_start = render_escalating(
        lambda p: render(*arrays, cam, 3, scene.width, scene.height,
                         alive=alive, fragment_profile=p),
        alive.shape[0], profile, escalated_profile)
    mse = float(l2_loss(torch.clamp(out["rendered_image"], 0.0, 1.0), gt))
    return (mse, -10.0 * float(np.log10(mse)), int(out["dropped"]),
            profiles[-1], dropped_at_start)


def evaluate(joint: RoDyGSTrainer, scene: Scene, frames: Frames, gt_profile,
             eval_w_align: bool, w_align_steps: int = 1000) -> dict:
    """PSNR on train view 0 and on the held-out pose (GT rendered at the GT
    profile, escalated if needed; each PSNR render from the trainer's
    dynamic profile, escalated if needed, with the fragments it dropped at
    that profile in "dropped_at_train_profile"); with `eval_w_align` the
    test-time pose optimisation of the held-out view from the nearest
    trained pose (`w_align_steps` Adam steps at lr 5e-5 through the
    pose-only render path, at the held-out render's profile), timed, with
    the PSNR and L2 it starts from and ends at."""
    start = joint.dyn_fragment_profile
    _, psnr_train, dropped_tr, prof_tr, start_tr = mse_psnr(
        joint, scene, frames.cameras[0], frames.images[0], 0.0, start)
    cam_mid, t_mid = holdout_camera(scene)
    gt_mid, _, tried = render_gt(scene, cam_mid, t_mid, gt_profile)
    _, psnr_holdout, dropped_ho, prof_ho, start_ho = mse_psnr(
        joint, scene, cam_mid, gt_mid, t_mid, start)
    res = {"psnr_train": psnr_train, "dropped_train": dropped_tr,
           "psnr_holdout": psnr_holdout, "dropped_holdout": dropped_ho,
           "dropped_at_train_profile": [start_tr, start_ho],
           "gt_profile": tried[-1], "profiles": [prof_tr, prof_ho],
           "w_align": None}
    if not eval_w_align:
        return res

    *arrays, alive = concatenated(joint, t_mid)

    def render_fn(cam):
        out = render(*arrays, cam, 3, scene.width, scene.height, alive=alive,
                     fragment_profile=prof_ho, include_normal=False,
                     pose_grad_only=True)
        return torch.clamp(out["rendered_image"], 0.0, 1.0)

    poses = joint.static.state.poses
    trained = c2w_mats(poses.q_c2w.cpu().numpy(), poses.t_c2w.cpu().numpy())
    gt_mid_mat = c2w_mats(cam_mid.q_c2w.cpu().numpy()[None],
                          cam_mid.t_c2w.cpu().numpy()[None])[0]
    po = PoseOptimizer(trained, trained, render_fn, camera_lr=W_ALIGN_LR,
                       num_opts=w_align_steps)
    # the raw nearest-train pose: where the optimisation starts
    near = trained[int(np.argsort(np.linalg.norm(
        trained[:, :3, 3] - gt_mid_mat[:3, 3], axis=1))[0])]
    dev = cam_mid.q_c2w.device
    cam_near = cam_mid._replace(
        q_c2w=matrix_to_quat(torch.tensor(near[:3, :3], dtype=torch.float32,
                                          device=dev)),
        t_c2w=torch.tensor(near[:3, 3], dtype=torch.float32, device=dev))
    l2_near, psnr_near, *_ = mse_psnr(joint, scene, cam_near, gt_mid, t_mid,
                                        prof_ho)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_wa = time.time()
    cam_opt = po(cam_mid, gt_mid_mat, gt_mid)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wa_s = time.time() - t_wa
    l2_aligned, psnr_aligned, *_ = mse_psnr(joint, scene, cam_opt, gt_mid,
                                              t_mid, prof_ho)
    res["w_align"] = {"s_per_view": round(wa_s, 2), "num_opts": w_align_steps,
                      "camera_lr": W_ALIGN_LR,
                      "psnr_nearest_init": round(psnr_near, 2),
                      "psnr_aligned": round(psnr_aligned, 2),
                      "psnr_gt_pose": round(psnr_holdout, 2),
                      "l2_nearest_init": l2_near, "l2_aligned": l2_aligned}
    log(f"eval_w_align: {res['w_align']}")
    return res


@torch.no_grad()
def fragment_demand(joint: RoDyGSTrainer, scene: Scene, cam: Camera) -> dict:
    """Fragments the static set's render of `cam` needs in each binning
    mode: circle rects ("loose"), the alpha-cut AABB ("tight") and the
    per-tile-row spans ("rows")."""
    st = joint.static.state.store
    sp = st.params
    tx, ty = tile_grid(scene.width, scene.height)
    splats = preprocess(sp.xyz, G.get_scaling(sp), sp.rotation,
                        G.get_opacity(sp), G.get_features(sp), 3, cam,
                        scene.width, scene.height, alive=st.alive)
    return {name: int(build_binning(splats, tx, ty, 1 << 23,
                                    tight=mode).num_fragments)
            for name, mode in (("loose", False), ("tight", True),
                               ("rows", "rows"))}


class Prepared(NamedTuple):
    device: torch.device
    scene: Scene
    frames: Frames
    gt_profile: object
    joint: RoDyGSTrainer
    pose_noise: dict   # {} without pose noise


def prepare(args) -> Prepared:
    """Everything before training: the scene, the GT views, the pose noise
    and its pre-alignment, the joint trainer."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    W, H, N = args.width, args.height, args.n
    rng = np.random.default_rng(13)
    log(f"scene: {W}x{H}, {N} static + {N} dynamic gaussians on {device}")
    t0 = time.time()
    scene = make_scene(N, rng, W, H, args.scale_inflate, device)
    log(f"stores built in {time.time() - t0:.1f}s")
    t0 = time.time()
    frames, gt_profile = gt_views(scene, args.motion_masks)
    log(f"{N_FRAMES} GT views in {time.time() - t0:.1f}s (GT profile "
        f"{gt_profile})")

    init_q, init_t = scene.gt_q.copy(), scene.gt_t.copy()
    pose_noise = {}
    if args.pose_noise_rot_deg > 0 or args.pose_noise_trans > 0:
        init_q, init_t = perturb_poses(scene.gt_q, scene.gt_t, rng,
                                       args.pose_noise_rot_deg,
                                       args.pose_noise_trans)
        pose_noise = {"rot_deg": args.pose_noise_rot_deg,
                      "trans_sigma": args.pose_noise_trans,
                      "init_scores": pose_scores(scene.gt_q, scene.gt_t,
                                                 init_q, init_t)}
        log(f"pose noise: {pose_noise}")
        # a resumed run restores its poses from the trainer state
        resuming = (args.resume_every
                    and (Path(args.state_dir) / "resume.ckpt").exists())
        if args.pose_prealign and resuming:
            log("prealign skipped (resume checkpoint exists)")
        elif args.pose_prealign:
            log("pose pre-alignment (coarse-to-fine)...")
            init_q, init_t, info = pose_prealign(
                scene.static_init, init_q, init_t, frames,
                args.prealign_steps, args.prealign_retry_thresh, W, H)
            pose_noise["prealign"] = info
            pose_noise["prealign_scores"] = pose_scores(
                scene.gt_q, scene.gt_t, init_q, init_t)
            log(f"prealign: {info} -> {pose_noise['prealign_scores']}")
    poses = CameraPoses(q_c2w=torch.tensor(init_q, device=device),
                        t_c2w=torch.tensor(init_t, device=device))
    joint = build_joint(scene, poses, args, device)
    return Prepared(device, scene, frames, gt_profile, joint, pose_noise)


def finish(args, prep: Prepared, hist: dict) -> tuple[dict, dict]:
    """Everything after training: evaluation and the result dict. Returns
    (the result, evaluate's dict)."""
    device, scene, frames, joint = (prep.device, prep.scene, prep.frames,
                                    prep.joint)
    W, H, N = args.width, args.height, args.n
    pose_noise = hist["pose_noise"]
    window_times = hist["window_times"]
    steady = float(np.median(window_times[1:] if len(window_times) > 2
                             else window_times))
    # each joint iteration renders the frame twice (static + dynamic stage)
    mpix_s = 2 * (W * H / 1e6) / steady

    ev = evaluate(joint, scene, frames, prep.gt_profile, args.eval_w_align,
                  args.w_align_steps)
    mem = {"peak_hbm_gb": (round(torch.cuda.max_memory_allocated(device)
                                 / 2**30, 2)
                           if device.type == "cuda" else None),
           "fragment_demand_static_view0": fragment_demand(
               joint, scene, frames.cameras[0])}
    st = joint.static.state
    if pose_noise:
        fq, ft = st.poses.q_c2w.cpu().numpy(), st.poses.t_c2w.cpu().numpy()
        pose_noise["final_scores"] = pose_scores(scene.gt_q, scene.gt_t, fq, ft)
        pose_noise["final_q"] = fq.tolist()
        pose_noise["final_t"] = ft.tolist()
        log(f"pose recovery: init={pose_noise['init_scores']} "
            f"final={pose_noise['final_scores']}")

    until_s, until_d = densify_until(args)
    dropped_last = list(hist["dropped_last"])
    result = {
        "workload": f"{W}x{H}, 2x{N} gaussians, full joint step "
                    "(static+dynamic+densify+pose-opt, 8-term dyn loss)",
        "device": device_label(device),
        "schedule": {"densify_from": args.densify_from,
                     "densify_until": [until_s, until_d],
                     "sh_up_start": args.sh_up_start},
        "pose_noise": pose_noise or None,
        "alive_traj": hist["alive_traj"],
        "rss_traj_mb": hist["rss_traj"],
        "loss_traj": hist["loss_traj"],
        "eval_w_align": ev["w_align"],
        "resumed_from": hist["resumed_from"],
        "steps": args.iters,
        "step_ms_median": round(steady * 1e3, 1),
        "mpix_per_s_fwd_bwd": round(mpix_s, 3),
        "window_ms": [round(t * 1e3, 1) for t in window_times],
        "step_ms_last_window": round(window_times[-1] * 1e3, 1),
        "mpix_per_s_last_window": round(
            2 * (W * H / 1e6) / window_times[-1], 3),
        "train_wall_s": round(hist["train_s"], 1),
        "escalations": hist["escalations"],
        "final_profiles": [joint.static.fragment_profile,
                           joint.dyn_fragment_profile],
        "dropped_final": dropped_last,
        "dropped_eval": [ev["dropped_train"], ev["dropped_holdout"]],
        "dropped_eval_at_train_profile": ev["dropped_at_train_profile"],
        "psnr_train_view": round(ev["psnr_train"], 2),
        "psnr_holdout_view": round(ev["psnr_holdout"], 2),
        "n_alive_static": int(G.num_alive(st.store)),
        "n_alive_dynamic": int(G.num_alive(joint.dynamic.state.store)),
        **mem,
    }
    return result, ev


def run(args) -> dict:
    """`prepare`, `train` and `finish`: the result dict."""
    prep = prepare(args)
    log(f"training {args.iters} joint iterations...")
    hist = train(prep.joint, prep.frames, args, prep.scene, prep.pose_noise)
    return finish(args, prep, hist)[0]


def main(args) -> dict:
    """`run`, its result printed as one JSON line (and written to
    `args.out` if set); raises when fragments are still dropped at the end,
    unless `args.allow_drops`. Returns the result dict."""
    result = run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    # the silent-quality-loss check: after escalation nothing may still be
    # dropped
    if not args.allow_drops and (result["dropped_final"] != [0, 0]
                                 or any(result["dropped_eval"])):
        raise RuntimeError(f"fragments still dropped at the end of the run: "
                           f"final {result['dropped_final']}, eval "
                           f"{result['dropped_eval']}")
    log(f"OK{' -> ' + args.out if args.out else ''}")
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.flagship_1080p",
        description="The joint RoDyGS run at flagship scale on a synthetic "
                    "scene.")
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--n", type=int, default=120000)
    p.add_argument("--out", default=None,
                   help="also write the result JSON here (default: print "
                        "only)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--allow_drops", action="store_true",
                   help="skip the final zero-drop check (stress runs)")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--sh_up_start", type=int, default=10**9,
                   help="reference kubric: 15000 (sh ramp 0->3 after)")
    p.add_argument("--densify_from", type=int, default=100,
                   help="reference kubric: 500")
    p.add_argument("--densify_until_static", type=int, default=-1,
                   help="-1 = iters (reference kubric: 20000)")
    p.add_argument("--densify_until_dynamic", type=int, default=-1,
                   help="-1 = iters (reference kubric: 15000)")
    p.add_argument("--pose_noise_rot_deg", type=float, default=0.0)
    p.add_argument("--pose_noise_trans", type=float, default=0.0)
    p.add_argument("--camera_rotation_lr", type=float, default=1e-5,
                   help="reference kubric value; raise for hard pose rungs")
    p.add_argument("--camera_translation_lr", type=float, default=1e-6)
    p.add_argument("--scene_lr_delay", type=int, default=0,
                   help="pose-first warmup: scene LRs zeroed for the first "
                        "N iterations (hard pose rungs)")
    p.add_argument("--camera_sparse_adam", action="store_true",
                   help="frame-masked camera Adam (per-camera moments)")
    p.add_argument("--pose_prealign", action="store_true",
                   help="coarse-to-fine per-view pose pre-alignment against "
                        "the init scene before joint training")
    p.add_argument("--eval_w_align", action="store_true",
                   help="run the test-time pose optimisation on the holdout "
                        "view and record s/view + PSNR delta")
    p.add_argument("--w_align_steps", type=int, default=1000,
                   help="its Adam steps (eval_w_align.yaml: 1000)")
    p.add_argument("--prealign_retry_thresh", type=float, default=0.022,
                   help="absolute per-view loss above which a prealigned "
                        "view counts as diverged and gets the multi-start "
                        "retry (also gated at 1.8x the 25th pct loss)")
    p.add_argument("--prealign_steps", type=int, default=250,
                   help="Adam steps per pre-alignment level")
    p.add_argument("--camera_total_steps", type=int, default=-1,
                   help="cosine-anneal horizon for the camera LRs; > iters "
                        "keeps late pose steps alive (-1 = iters)")
    p.add_argument("--scale_inflate", type=float, default=2.5,
                   help="init-footprint inflation (2.5 exercises the "
                        "escalation ladder; 1.0 = GT-like for pose rungs)")
    p.add_argument("--motion_masks", action="store_true",
                   help="mask the dynamic region out of the static-stage "
                        "losses (masks from the GT dynamic alpha)")
    p.add_argument("--resume_every", type=int, default=0,
                   help="save a resume snapshot every N iters (0=off)")
    p.add_argument("--state_dir", default="logs/flagship_torch_state")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
