"""Config-driven assembly: YAML -> datamodules, models, trainers. Port of
`rodygs_tpu/pipelines/build.py`.

The shipped YAMLs name the reference's classes; utils/config.py maps them
onto the `*Spec` classes here, which keep the constructor params, and
`build_training_run` assembles the trainers from them and the loaded data.
The trainers draw from seeded `torch.Generator`s: the static trainer's is
seeded with `seed`, the dynamic trainer's with `seed + 1`.

On a mesh (`mesh=`) every iteration consumes `mesh.shape["data"]` frames:
every rank draws the same stacked batch from the same seeded samplers
(cycling them when they bound their length), and the sharded steps take
row `coords["data"]`. The resume decision is the primary's
(`multihost.broadcast_flag`), so no rank can skip the collectives of a
load another rank takes.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from ..data.datamodule import GSDataModule
from ..models import gaussians as G
from ..parallel.multihost import broadcast_flag
from ..train.losses import MultiLoss
from ..train.optim import CameraPoses
from ..train.trainer_dynamic import DynTrainer, DynTrainerConfig
from ..train.trainer_joint import RoDyGSTrainer
from ..train.trainer_static import (
    FrameBatch, StaticTrainerConfig, ThreeDGSTrainer)
from ..utils.config import instantiate_from_config
from ..utils.platform import resolve_device
from ..utils.profiling import StepTimer


class _Spec:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


class StaticModelSpec(_Spec):
    """`src.model.rodygs_static.StaticRoDyGS` params."""


class DynModelSpec(_Spec):
    """`src.model.rodygs_dynamic.DynRoDyGS` params."""


class StaticTrainerSpec(_Spec):
    """`src.trainer.rodygs_static.ThreeDGSTrainer` params."""


class DynTrainerSpec(_Spec):
    """`src.trainer.rodygs_dynamic.DynTrainer` params."""


class CameraOptSpec(_Spec):
    """`src.trainer.optim.CameraQuatOptimizer` params."""


class MultiLossSpec(_Spec):
    def build(self) -> MultiLoss:
        return MultiLoss.from_config(self.kwargs["loss_configs"])


class JointTrainerSpec(_Spec):
    """`src.trainer.rodygs.RoDyGSTrainer` params (static/dynamic sub-specs)."""


def _trainer_cfg_kwargs(spec_kwargs: dict, image_width: int, image_height: int,
                        model_kwargs: dict, dataclass) -> dict:
    """Map the reference's trainer params onto the config dataclass."""
    cam = spec_kwargs.get("camera_opt_config")
    cam_params = dict((cam or {}).get("params") or {})
    fields = {f for f in dataclass.__dataclass_fields__}
    out = {k: v for k, v in spec_kwargs.items() if k in fields}
    out.update({
        "image_width": image_width,
        "image_height": image_height,
        "sh_degree": model_kwargs.get("sh_degree", 3),
        "isotropic": model_kwargs.get("isotropic", False),
        "camera_rotation_lr": cam_params.get("camera_rotation_lr", 0.0),
        "camera_translation_lr": cam_params.get("camera_translation_lr", 0.0),
        "camera_lr_warmup": cam_params.get("camera_lr_warmup", 0),
        "camera_total_steps": cam_params.get(
            "total_steps", spec_kwargs.get("num_iterations", 20000)),
    })
    for k in ("deform_netwidth", "deform_t_emb_multires",
              "deform_t_log_sampling", "num_basis", "inverse_motion",
              "activation"):
        if k in model_kwargs and k in fields:
            out[k] = model_kwargs[k]
    return out


def make_frame_batch(frame: dict, frame_idx: int, device) -> FrameBatch:
    """One dataset frame as a `FrameBatch` on `device` (float32 tensors)."""
    def dev(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32).to(device, non_blocking=True)

    return FrameBatch(
        gt_image=dev(frame["image"]),
        gt_depth=dev(frame["depth"]),
        motion_mask=dev(frame["motion_mask"]),
        frame_idx=int(frame_idx),
        time=torch.tensor(frame["time"], dtype=torch.float32, device=device),
        fovx=torch.tensor(frame["fovx"], dtype=torch.float32, device=device),
        fovy=torch.tensor(frame["fovy"], dtype=torch.float32, device=device),
    )


class TrainingRun:
    """The assembled training job: the host loop of the reference's
    `RoDyGSTrainer.train`."""

    def __init__(self, joint: RoDyGSTrainer, static_dm: GSDataModule,
                 dynamic_dm: GSDataModule | None, num_iterations: int,
                 logdir: Path | None, log_freq: int = 50, seed: int = 777,
                 logger=None, checkpoint_every: int = 0, mesh=None):
        self.joint = joint
        self.static_dm = static_dm
        self.dynamic_dm = dynamic_dm
        self.num_iterations = num_iterations
        self.logdir = logdir
        self.log_freq = log_freq
        self.seed = seed
        self.logger = logger
        # 0 = end-only (the reference's behaviour); k > 0 also saves a
        # resumable snapshot every k iterations
        self.checkpoint_every = checkpoint_every
        self.device = joint.static.device
        self.mesh = mesh
        self.frames_per_iter = 1 if mesh is None else mesh.shape["data"]

    def _log(self, msg: str):
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg)

    def _static_alive(self) -> int:
        """Alive static Gaussians over every gauss block (a collective on a
        mesh: every rank logs on the same iterations)."""
        alive = G.num_alive(self.joint.static.state.store)
        if self.mesh is not None:
            from ..parallel.collectives import psum

            alive = psum(alive.reshape(1), self.mesh.axis("gauss"))
        return int(alive)

    def train(self, resume: bool = False) -> RoDyGSTrainer:
        start_iter = 1
        resume_path = (self.logdir / "resume.ckpt"
                       if self.logdir is not None else None)
        if broadcast_flag(resume and resume_path is not None
                          and resume_path.exists()):
            self.joint.logdir = Path(self.logdir)
            start_iter = self.joint.load_resume(resume_path)
            self._log(f"resumed from {resume_path} at iteration {start_iter}")
        timer = StepTimer()
        static_iter = iter(self.static_dm.get_train_sampler())
        dyn_iter = (iter(self.dynamic_dm.get_train_sampler())
                    if self.dynamic_dm is not None
                    and not self.joint.skip_dynamic else None)
        static_dset = self.static_dm.get_train_dset()
        dyn_dset = (self.dynamic_dm.get_train_dset()
                    if dyn_iter is not None else None)
        t0 = time.time()

        def draw(it_, dm, dset):
            """The next frame, restarting a sampler that bounds its length."""
            try:
                idx = next(it_)
            except StopIteration:
                it_ = iter(dm.get_train_sampler())
                idx = next(it_)
            return make_frame_batch(dset[idx], idx, self.device), it_

        def draw_batch(it_, dm, dset):
            if self.mesh is None:
                return draw(it_, dm, dset)
            from ..parallel.sharded import stack_batches

            frames = []
            for _ in range(self.frames_per_iter):
                frame, it_ = draw(it_, dm, dset)
                frames.append(frame)
            return stack_batches(frames), it_

        for it in range(start_iter, self.num_iterations + 1):
            sb, static_iter = draw_batch(static_iter, self.static_dm,
                                         static_dset)
            db = None
            if dyn_iter is not None:
                db, dyn_iter = draw_batch(dyn_iter, self.dynamic_dm, dyn_dset)
            metrics = self.joint.train_iteration(sb, db, it)
            timer.tick()
            if (self.checkpoint_every and self.logdir is not None
                    and it % self.checkpoint_every == 0):
                self.joint.logdir = Path(self.logdir)
                self.joint.save_resume(self.logdir / "resume.ckpt", it)
            if it % self.log_freq == 0 or it == 1:
                s_loss = float(metrics["static"]["loss"])
                d_loss = (float(metrics["dynamic"]["loss"])
                          if "dynamic" in metrics else float("nan"))
                alive_s = self._static_alive()
                tstats = timer.summary()
                self._log(
                    f"[{it}/{self.num_iterations}] static {s_loss:.4f} "
                    f"dynamic {d_loss:.4f} N_static {alive_s} "
                    f"step p50 {tstats.get('p50_ms', 0):.0f}ms "
                    f"({(time.time() - t0):.0f}s)")
        self._log(f"step times {json.dumps(timer.summary())}")
        if self.logdir is not None:
            self.joint.logdir = Path(self.logdir)
            self.joint.save_checkpoints(self.num_iterations)
            self._log(f"checkpoints saved to {self.logdir}")
        return self.joint


def build_training_run(config: dict, dirpath: str | None = None,
                       logdir: str | Path | None = None,
                       seed: int = 777, capacity_factor: float = 4.0,
                       logger=None, device=None, mesh=None) -> TrainingRun:
    """Assemble the training job from a merged reference-style config, on
    `device` (`cuda` unless the caller asks for the CPU), or on this rank's
    device of `mesh` (the trainers' mesh branches)."""
    from ..utils.native import backend

    dev = resolve_device(mesh.device if mesh is not None else device)
    t0 = time.perf_counter()
    static_dm = instantiate_from_config(
        config["static_data"],
        **({"dirpath": dirpath} if dirpath else {}))
    skip_dynamic = static_dm.skip_dynamic
    dynamic_dm = None
    if not skip_dynamic:
        dynamic_dm = instantiate_from_config(
            config["dynamic_data"],
            **({"dirpath": dirpath} if dirpath else {}))
    if logger is not None:
        logger.info(f"data loaded in {time.perf_counter() - t0:.3f} s "
                    f"(host ops: {backend()})")

    static_model_kwargs = dict(config["static_model"].get("params") or {})
    trainer_cfg = config["trainer"]["params"]
    static_spec = trainer_cfg["static"]["params"]
    dset = static_dm.get_train_dset()
    w, h = dset.image_width, dset.image_height

    # --- static ------------------------------------------------------------
    s_cfg = StaticTrainerConfig(**_trainer_cfg_kwargs(
        static_spec, w, h, static_model_kwargs, StaticTrainerConfig))
    s_loss = MultiLoss.from_config(
        static_spec["loss_config"]["params"]["loss_configs"])
    pcd = static_dm.get_init_pcd()
    s_norm = static_dm.get_normalization()["radius"]
    s_store = G.from_point_cloud(
        pcd.points, pcd.colors, sh_degree=s_cfg.sh_degree,
        times=pcd.time, isotropic=s_cfg.isotropic,
        capacity_factor=capacity_factor, device=dev)
    poses = CameraPoses(q_c2w=torch.as_tensor(dset.q_c2w, device=dev),
                        t_c2w=torch.as_tensor(dset.t_c2w, device=dev))
    static_trainer = ThreeDGSTrainer(s_cfg, s_loss, s_store, poses, s_norm,
                                     device=dev, seed=seed, mesh=mesh)

    # --- dynamic -----------------------------------------------------------
    dyn_trainer = None
    if not skip_dynamic:
        dyn_model_kwargs = dict(config["dynamic_model"].get("params") or {})
        dyn_spec = trainer_cfg["dynamic"]["params"]
        d_cfg = DynTrainerConfig(**_trainer_cfg_kwargs(
            dyn_spec, w, h, dyn_model_kwargs, DynTrainerConfig))
        d_loss = MultiLoss.from_config(
            dyn_spec["loss_config"]["params"]["loss_configs"])
        if s_cfg.isotropic != d_cfg.isotropic:
            raise ValueError("the static and the dynamic Gaussians must both "
                             "be isotropic or both anisotropic")
        d_pcd = dynamic_dm.get_init_pcd()
        d_norm = dynamic_dm.get_normalization()["radius"]
        d_store = G.from_point_cloud(
            d_pcd.points, d_pcd.colors, sh_degree=d_cfg.sh_degree,
            times=d_pcd.time, isotropic=d_cfg.isotropic,
            capacity_factor=capacity_factor, device=dev)
        dyn_trainer = DynTrainer(d_cfg, d_loss, d_store, d_norm,
                                 seed=seed + 1, device=dev, mesh=mesh)

    joint = RoDyGSTrainer(
        static_trainer, dyn_trainer,
        sh_up_start_iteration=trainer_cfg.get("sh_up_start_iteration", 0),
        sh_up_period=trainer_cfg.get("sh_up_period", 1000),
        log_freq=trainer_cfg.get("log_freq", 50),
        logdir=logdir, mesh=mesh)

    num_iterations = static_spec["num_iterations"]
    return TrainingRun(joint, static_dm, dynamic_dm, num_iterations,
                       Path(logdir) if logdir else None,
                       log_freq=trainer_cfg.get("log_freq", 50), seed=seed,
                       logger=logger, mesh=mesh)
