"""End-to-end evaluator: checkpoint loading, per-view rendering and
metrics, train-pose ATE/RPE, result.yaml, PNG and video export. Port of
`rodygs_tpu/evalsuite/evaluator.py`.

Loads `static_last.ckpt` / `dynamic_last.ckpt`, optionally runs test-time
pose optimisation per test view, renders the concatenated static +
deformed dynamic set, scores PSNR / SSIM / MS-SSIM / DSSIM / LPIPS, writes
per-frame 16-bit PNGs, `result.yaml` and `video.mp4`, and scores the
train poses against GT. The datamodules are `data/datamodule.GSDataModule`s
or anything with the same surface:
`get_test_dset()` (frames with image, image_name, time, fovx, fovy;
`q_c2w` / `t_c2w` arrays; `image_width` / `image_height`),
`get_test_sampler()`, `get_train_poses()`, `get_normalization()` and
`skip_dynamic`.

With several processes (parallel/multihost.py) only the primary writes
the PNGs, `result.yaml` and the video.

The JAX package renders a chunk of views as one `lax.map` and pads the last
chunk by repetition so it compiles once; here a chunk is a loop over its
views and the padding is never rendered. The chunking and the `timing`
keys stay.

Departures from the JAX evaluator, each a fault of its own:
  * after a view drops fragments, a banded profile first falls back to
    fewer bands at the same capacity before it widens (the trainers'
    `EscalationPoller` policy). The JAX evaluator widens only, which finds
    nothing when one band overflows while the total fits, and then scores
    a clipped render;
  * test-time pose optimisation renders the static set at a profile of its
    own, fitted by a probe of each view before its steps, and a step whose
    render drops fragments escalates (`escalated_profile`) and is taken
    again; the JAX evaluator renders every step at "lean" and never looks
    at the drops. `pose_render_stats` counts the steps, the retried ones
    and those whose render still dropped;
  * the pose optimisation's render passes the static model's isotropy to
    `get_scaling` (an isotropic model's [C, 1] scales made the JAX one
    fail in `preprocess`).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import yaml

from ..data.readers import GTCameraReader
from ..models import gaussians as G
from ..models import motion as M
from ..ops.quaternion import quat_to_matrix
from ..parallel.multihost import is_primary
from ..render.camera import Camera, make_camera
from ..render.compact import (bands_decision, bands_viable, fit_capacity,
                              fragment_capacity, join_profile,
                              profile_for_demand, split_profile)
from ..render.rasterize import render
from ..utils.checkpoint import load_checkpoint
from ..utils.platform import resolve_device
from ..utils.store import AssetStorer, write_video
from .metrics import VizScoreEvaluator, ms_ssim_levels
from .pose_metrics import PoseEvaluator
from .pose_opt import PoseOptimizer


def eval_fit_profile(n: int, demand: int, current):
    """Demand-fitted fragment profile for the (forward-only) evaluator:
    shrink to the fitted capacity when it sits a grid step below the
    current one, then band it as the trainers do (bands_decision)."""
    prof_cur, _ = split_profile(current)   # never nest (profile, bands)
    fit = fit_capacity(n, demand)
    if fit * 5 // 4 > fragment_capacity(n, prof_cur):
        fit = prof_cur
    cap = fragment_capacity(n, fit)
    return join_profile(fit, bands_decision(n, cap, demand))


def escalated_profile(n: int, demand: int, current):
    """The profile to render again with after a render dropped fragments,
    or None when none can hold more: a banded profile first keeps its
    capacity with the most bands it still fits (one band can overflow
    while the total fits), an unbanded one widens (profile_for_demand)."""
    prof, bands = split_profile(current)
    cap = fragment_capacity(n, prof)
    for b in range(bands - 1, 0, -1):
        if bands_viable(n, cap, demand, b):
            return join_profile(prof, b)
    return profile_for_demand(n, demand, prof)


def fitted_profile(render_at, n: int, profile):
    """The profile a probe fits: escalate until `render_at(profile)` drops
    nothing (clipped fragments would bias every metric and every pose
    gradient), then shrink to the demand-fitted size when the demand sits a
    grid step below the capacity (eval_fit_profile). Eval renders a
    converged scene, whose per-view demand varies far less than the
    sizers' headroom. At the legal maximum the last profile stays and the
    drops stay visible."""
    while True:
        out = render_at(profile)
        demand = int(out["num_fragments"])
        if not bool(out["overflow"]):
            return eval_fit_profile(n, demand, profile)
        wider = escalated_profile(n, demand, profile)
        if wider is None:
            return profile
        profile = wider


def chunk_padded(seq, size: int):
    """Split `seq` into fixed-size chunks. Yields `(chunk, padded)` pairs:
    `chunk` is the real slice, `padded` the same slice right-padded by
    repeating its last element so every yield has the same length."""
    b = max(1, min(size, len(seq)))
    for c0 in range(0, len(seq), b):
        chunk = list(seq[c0:c0 + b])
        yield chunk, chunk + [chunk[-1]] * (b - len(chunk))


class RoDyGSEvaluator:
    def __init__(self, dirpath, static_datamodule, dynamic_datamodule,
                 out_path, static_ckpt_path, dynamic_ckpt_path,
                 camera_lr: float = -1, num_opts: int = -1,
                 lpips_weights: str | None = None, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.dirpath = dirpath
        self.static_datamodule = static_datamodule
        self.out_path = Path(out_path)
        self.out_path.mkdir(parents=True, exist_ok=True)

        static_sd, _ = load_checkpoint(static_ckpt_path)
        self.static_store = G.from_state_dict(static_sd["model"], device=dev)
        # isotropic models store [C, 1] log-scales
        self.static_isotropic = self.static_store.params.scaling.shape[1] == 1
        self.active_sh_degree = int(static_sd["active_sh_degree"])

        self.skip_dynamic = static_datamodule.skip_dynamic
        if not self.skip_dynamic:
            dynamic_sd, _ = load_checkpoint(dynamic_ckpt_path)
            model = dynamic_sd["model"]
            self.dyn_store = G.from_state_dict(model, device=dev)
            self.dyn_isotropic = self.dyn_store.params.scaling.shape[1] == 1
            self.motion_coeff = torch.as_tensor(model["_motion_coeff"],
                                                device=dev)
            self.net = {part: {k: torch.as_tensor(v, device=dev)
                               for k, v in layers.items()}
                        for part, layers in model["_deform_network"].items()}
            # the net's widths from its weights
            w0 = self.net["timenet"]["w0"]
            self.net_cfg = M.MotionNetConfig(
                netwidth=w0.shape[1],
                num_basis=self.net["heads"]["w0"].shape[0],
                t_emb_multires=(w0.shape[0] - 1) // 2,
            )
            self.dyn_spatial_lr_scale = float(
                dynamic_datamodule.get_normalization()["radius"])
            self.inverse_motion = bool(dynamic_sd.get("inverse_motion", True))
            self.unique_times = torch.tensor(
                G.unique_times(self.dyn_store), dtype=torch.float32,
                device=dev)

        self.viz_evaluator = VizScoreEvaluator(lpips_weights, device=dev)
        self.pose_evaluator = PoseEvaluator()
        self.gt_storer = AssetStorer(self.out_path / "gt")
        self.pred_storer = AssetStorer(self.out_path / "pred")

        self.test_dset = static_datamodule.get_test_dset()
        self.image_width = self.test_dset.image_width
        self.image_height = self.test_dset.image_height

        # fragment capacities: fitted by probe renders, the concatenated
        # set's before the chunks, the static set's before each view's pose
        # steps
        self.fragment_profile: str | int | tuple = "lean"
        self.pose_fragment_profile: str | int | tuple = "lean"
        self.pose_render_stats = {"steps": 0, "retried": 0, "dropped": 0}

        self.is_optimizable_cam = camera_lr != -1
        if self.is_optimizable_cam:
            # refined train poses come from the checkpoint's camera section
            cam = static_sd["camera"]
            q = torch.as_tensor(np.asarray(cam["q_c2w"], np.float32))
            calib = np.tile(np.eye(4, dtype=np.float32), (len(q), 1, 1))
            calib[:, :3, :3] = quat_to_matrix(q).numpy()
            calib[:, :3, 3] = np.asarray(cam["t_c2w"])
            gt_train = GTCameraReader(dirpath, "train_transforms.json").get_poses()
            self.pose_optimizer = PoseOptimizer(
                calib, gt_train, self._render_rgb_for_poseopt,
                camera_lr, num_opts)

    # --- rendering ---------------------------------------------------------

    def _num_gaussians(self) -> int:
        return G.capacity_of(self.static_store) + (
            0 if self.skip_dynamic else G.capacity_of(self.dyn_store))

    def _concat_arrays(self, time):
        sp = self.static_store.params
        arrays = [
            sp.xyz, G.get_features(sp), G.get_opacity(sp),
            G.get_scaling(sp, self.static_isotropic), G.get_rotation(sp),
            self.static_store.alive,
        ]
        if self.skip_dynamic:
            return arrays
        dp = self.dyn_store.params
        transl, rot_delta = M.gaussian_deformation(
            self.net, self.net_cfg, self.motion_coeff, time,
            self.dyn_spatial_lr_scale, inverse_motion=self.inverse_motion,
            time_ind=self.dyn_store.time_ind, times_table=self.unique_times)
        # isotropic dynamic models ignore the rotation delta
        dyn_rot = (G.get_rotation(dp) if self.dyn_isotropic
                   else G.get_rotation(dp) + rot_delta)
        return [
            torch.cat([arrays[0], dp.xyz + transl]),
            torch.cat([arrays[1], G.get_features(dp)]),
            torch.cat([arrays[2], G.get_opacity(dp)]),
            torch.cat([arrays[3], G.get_scaling(dp, self.dyn_isotropic)]),
            torch.cat([arrays[4], dyn_rot]),
            torch.cat([arrays[5], self.dyn_store.alive]),
        ]

    @torch.no_grad()
    def render_view(self, camera: Camera, profile=None) -> dict:
        """The concatenated set's render of one view at `profile` (default:
        the current fragment profile); the output dict of `render`."""
        xyz, shs, opacity, scaling, rotation, alive = self._concat_arrays(
            camera.time)
        return render(xyz, shs, opacity, scaling, rotation, camera,
                      self.active_sh_degree, self.image_width,
                      self.image_height, alive=alive,
                      fragment_profile=(self.fragment_profile
                                        if profile is None else profile),
                      include_normal=False)

    def _render_static(self, camera: Camera, profile) -> dict:
        """The static set's render, pose gradients only (the Gaussians are
        frozen here, so the covariance and SH backward paths are gated
        off): what the reference's PoseOptimizer renders."""
        sp = self.static_store.params
        return render(sp.xyz, G.get_features(sp), G.get_opacity(sp),
                      G.get_scaling(sp, self.static_isotropic),
                      G.get_rotation(sp), camera, self.active_sh_degree,
                      self.image_width, self.image_height,
                      alive=self.static_store.alive, fragment_profile=profile,
                      include_normal=False, pose_grad_only=True)

    def _fit_fragment_profile(self, camera: Camera) -> None:
        self.fragment_profile = fitted_profile(
            lambda p: self.render_view(camera, p), self._num_gaussians(),
            self.fragment_profile)

    @torch.no_grad()
    def _fit_pose_profile(self, camera: Camera) -> None:
        self.pose_fragment_profile = fitted_profile(
            lambda p: self._render_static(camera, p),
            G.capacity_of(self.static_store), self.pose_fragment_profile)

    def _render_chunk(self, cams: list) -> list:
        """Render a chunk's views; while any view drops fragments, escalate
        to the chunk's largest demand and render them all again: reported
        metrics never come from a clipped render."""
        while True:
            outs = [self.render_view(c) for c in cams]
            if max(int(o["dropped"]) for o in outs) == 0:
                return outs
            wider = escalated_profile(
                self._num_gaussians(),
                max(int(o["num_fragments"]) for o in outs),
                self.fragment_profile)
            if wider is None:
                return outs
            self.fragment_profile = wider

    def _render_rgb_for_poseopt(self, camera: Camera) -> torch.Tensor:
        """A pose step's render: at the fitted pose profile; a render that
        drops fragments escalates the profile and is taken again, so the
        step's loss never comes from a clipped render."""
        stats = self.pose_render_stats
        stats["steps"] += 1
        retried = False
        while True:
            out = self._render_static(camera, self.pose_fragment_profile)
            dropped = int(out["dropped"])
            if dropped == 0:
                break
            wider = escalated_profile(G.capacity_of(self.static_store),
                                      int(out["num_fragments"]),
                                      self.pose_fragment_profile)
            if wider is None:
                stats["dropped"] += 1  # at the legal maximum
                break
            self.pose_fragment_profile = wider
            retried = True
        stats["retried"] += retried
        return out["rendered_image"]

    # --- main loop ---------------------------------------------------------

    def eval(self, eval_batch_size: int = 8) -> dict:
        # several processes: one writes the PNGs, result.yaml and the video
        primary = is_primary()
        # 1) resolve every test camera (with the optional pose optimisation)
        views = []
        for idx in self.static_datamodule.get_test_sampler():
            frame = self.test_dset[idx]
            q = self.test_dset.q_c2w[idx]
            t = self.test_dset.t_c2w[idx]
            camera = make_camera(q, t, frame["fovx"], frame["fovy"],
                                 frame["time"], device=self.device)
            if self.is_optimizable_cam:
                gt_c2w = np.eye(4, dtype=np.float32)
                gt_c2w[:3, :3] = quat_to_matrix(
                    torch.as_tensor(np.asarray(q, np.float32))).numpy()
                gt_c2w[:3, 3] = t
                self._fit_pose_profile(camera)
                camera = self.pose_optimizer(camera, gt_c2w, frame["image"])
            views.append((idx, frame, camera))

        # 2) fit the fragment capacity off a probe view, then render in
        # chunks, scoring and storing each view
        if views:
            self._fit_fragment_profile(views[0][2])
        scores: dict[str, list] = {}
        render_s = 0.0
        chunk_view_s: list[float] = []
        for chunk, _ in chunk_padded(views, eval_batch_size):
            t0 = time.perf_counter()
            outs = self._render_chunk([v[2] for v in chunk])
            preds = [o["rendered_image"].cpu().numpy() for o in outs]
            dt = time.perf_counter() - t0
            render_s += dt
            chunk_view_s.append(dt / len(chunk))
            for (idx, frame, _), pred in zip(chunk, preds):
                gt = frame["image"]
                score = self.viz_evaluator.get_score(gt, pred)
                for k, v in score.items():
                    scores.setdefault(k, []).append(v)
                name = f"{str(idx).zfill(5)}_{frame['image_name']}.png"
                if primary:
                    self.gt_storer(name, np.asarray(gt))
                    self.pred_storer(name, pred)

        def _mean(vals):
            arr = np.asarray(vals, np.float64)
            if np.isnan(arr).all():
                return float("nan")  # e.g. LPIPS without weights
            return float(np.nanmean(arr))

        result = {"viz": {k: _mean(v) for k, v in scores.items()}}
        levels = ms_ssim_levels(self.image_height, self.image_width)
        if levels < 5:
            # adaptive MS-SSIM dropped scales (metrics.ms_ssim): the values
            # are not comparable to fixed-5-scale implementations; its own
            # key keeps result["viz"] floats-only
            result["msssim_info"] = {"msssim_levels": levels}
            result["msssim_info"]["msssim_note"] = (
                f"image {self.image_width}x{self.image_height} supports only "
                f"{levels}/5 MS-SSIM scales; msssim/dssim are renormalized "
                "over the retained scales and not piqa-comparable")
        # render wall-clock: the first chunk pays the kernels' first
        # launches; the rest are the steady render throughput
        result["timing"] = {
            "render_s_total": round(render_s, 3),
            "render_s_per_view": round(render_s / max(1, len(views)), 4),
            "eval_batch_size": int(min(eval_batch_size, max(1, len(views)))),
        }
        if len(chunk_view_s) > 1:
            # no padding view is rendered, so a chunk's time is per its own
            # views
            result["timing"]["render_s_per_view_steady"] = round(
                float(np.median(chunk_view_s[1:])), 4)

        # train-pose metrics against GT
        calibrated = self.static_datamodule.get_train_poses()
        gt_poses = GTCameraReader(self.dirpath, "train_transforms.json").get_poses()
        pose_scores = self.pose_evaluator.get_score(gt_poses, calibrated)
        result["pose"] = {k: float(pose_scores[k])
                          for k in ("ATE", "RPE_trans", "RPE_rot")}

        if primary:
            with open(self.out_path / "result.yaml", "w") as f:
                yaml.safe_dump(result, f)
            # the PNG writes are asynchronous: flush before the video reads
            self.gt_storer.flush()
            self.pred_storer.flush()
            write_video(self.out_path / "pred" / "viz",
                        self.out_path / "video.mp4")
        return result
