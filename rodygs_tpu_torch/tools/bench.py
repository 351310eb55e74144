"""Benchmark: the static train step's fwd+bwd throughput on the card. Port of
`bench.py` at the repository root.

    python -m rodygs_tpu_torch.tools.bench [--device cpu]

Measures the steady-state fwd+bwd+Adam step time of the static trainer
(`ThreeDGSTrainer.train_iteration`: photometric L1 + D-SSIM, camera-pose
gradients on) on the JAX script's seeded scene and reports rendered
megapixels per second, the script's headline metric. Two points, as in
the JAX script:

  512x512 / 100k      capacity 131,072, 8 frames, 9 windows x 10 steps
  1920x1080 / 240k    capacity 262,144, 4 frames, 5 windows x 8 steps
                      (skipped with RODYGS_BENCH_SKIP_1080P=1)

Each point runs 95 warm-up iterations numbered 910-1004, so the capacity
poller polls at 925 / 950 / 975 / 1000 and settles before timing, then
its windows of iterations numbered from 2000; each window ends with a
`torch.cuda.synchronize()` and is timed on the host clock. The step time
is the median of the windows within 10% of the fastest one (host load
only ever adds time).

Prints the card's name and power limit, then as its last line ONE JSON
object with the JAX script's keys:

  {"metric": "train_step_fwd_bwd_mpix_per_s", "value": N, "unit": ...,
   "vs_baseline": N, "workloads": {...}, "host_load1": N}

`vs_baseline` compares against A100_REFERENCE_MPIX_S, the JAX script's
parity bar for the reference pipeline on an A100 (~75 ms a step at
~0.25 Mpix, ~3.5 Mpix/s). A failed 1080p point is written into
`workloads` as {"error": ...}, the line is still printed, and the tool
exits 1. Without a card it exits 2 unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..models import gaussians as G
from ..render.camera import make_camera
from ..render.rasterize import render
from ..train.losses import LossTerm, MultiLoss
from ..train.optim import CameraPoses
from ..train.trainer_static import (FrameBatch, StaticTrainerConfig,
                                    ThreeDGSTrainer)
from ..utils.platform import device_label, resolve_device

A100_REFERENCE_MPIX_S = 3.5
FOV = 0.9
WARMUP_ITERATIONS = (910, 95)       # first iteration number, count
WINDOW_FIRST_ITERATION = 2000
# the JAX script's two points (bench.py:193,202)
HEADLINE = dict(W=512, H=512, N=100_000, capacity=131072, n_frames=8,
                n_windows=9, iters_per_window=10)
FLAGSHIP = dict(W=1920, H=1080, N=240_000, capacity=262144, n_frames=4,
                n_windows=5, iters_per_window=8)


def require_device(device=None) -> torch.device:
    """The device to measure on: `cuda` unless the caller asks for the
    CPU; raises when there is no card (there is no fallback)."""
    return resolve_device(device)


def workload_name(W: int, H: int, N: int) -> str:
    return f"{W}x{H}_{N // 1000}k"


class Workload(NamedTuple):
    """The scene of one point: the trainer built on it (its config, loss,
    initial store and poses), the GT frames on the device and
    `batch_for(i)`, the FrameBatch of step i (frame i mod n_frames)."""

    trainer: ThreeDGSTrainer
    gts: list
    batch_for: Callable[[int], FrameBatch]


class Point(NamedTuple):
    """One measured point: bench.py's dict, the trainer as its timed
    windows left it, `batch_for` and the kernel launches counted over the
    timed windows alone."""

    result: dict
    trainer: ThreeDGSTrainer
    batch_for: Callable[[int], FrameBatch]
    launches: dict


def build_workload(W: int, H: int, N: int, capacity: int, n_frames: int,
                   scale_rng=(-4.0, -2.6), device=None) -> Workload:
    """The JAX script's scene (bench.py:78-131) from the same numpy draws:
    N points in a box with random colours in a store of `capacity` slots,
    SH 3, log-scales drawn over the whole capacity; `n_frames` poses on an
    arc; the GT frames rendered by the model itself, noised and clipped,
    kept on the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    pts = rng.uniform([-2.0, -2.0, 2.5], [2.0, 2.0, 7.0],
                      size=(N, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(N, 3)).astype(np.float32)
    store = G.from_point_cloud(pts, cols, sh_degree=3, capacity=capacity,
                               device=dev)
    # trained-scene-like footprints, not the KNN prior of a random cloud
    scales = np.exp(rng.uniform(*scale_rng, size=(capacity, 3))).astype(
        np.float32)
    store = store._replace(params=store.params._replace(
        scaling=torch.tensor(np.log(scales), device=dev)))

    qs, ts = [], []
    for ang in np.linspace(-0.2, 0.2, n_frames):
        qs.append([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        ts.append([np.sin(ang) * 4.0, 0, 0])
    poses = CameraPoses(
        q_c2w=torch.tensor(qs, dtype=torch.float32, device=dev),
        t_c2w=torch.tensor(ts, dtype=torch.float32, device=dev))

    loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                      LossTerm("d_ssim", 0.2, "SSIMLoss")])
    cfg = StaticTrainerConfig(
        image_width=W, image_height=H, sh_degree=3,
        densification_interval=0, densify_from_iter=10**9,
        camera_rotation_lr=1e-5, camera_translation_lr=1e-6)
    trainer = ThreeDGSTrainer(cfg, loss, store, poses, spatial_lr_scale=4.0,
                              device=dev)

    # identical GTs would give an exactly-zero loss: the noise keeps the
    # gradients and the fragment demand those of a training workload
    gt_rng = np.random.default_rng(11)
    gts = []
    p = store.params
    with torch.no_grad():
        for i in range(n_frames):
            cam = make_camera(poses.q_c2w[i], poses.t_c2w[i], FOV, FOV, 0.0,
                              device=dev)
            img = render(p.xyz, G.get_features(p), G.get_opacity(p),
                         G.get_scaling(p), p.rotation, cam, 3, W, H,
                         alive=store.alive)["rendered_image"].cpu().numpy()
            img = np.clip(img + gt_rng.normal(0, 0.05, img.shape), 0.0, 1.0)
            gts.append(torch.tensor(img, dtype=torch.float32, device=dev))

    def batch_for(i):
        return FrameBatch(gt_image=gts[i % n_frames], gt_depth=None,
                          motion_mask=None, frame_idx=i % n_frames,
                          time=torch.tensor(0.0, device=dev),
                          fovx=torch.tensor(FOV, device=dev),
                          fovy=torch.tensor(FOV, device=dev))

    return Workload(trainer, gts, batch_for)


def steady_median(windows) -> tuple[float, int]:
    """(median of the windows within 10% of the fastest, their count):
    a degraded tail cannot inflate it and a lone fast window cannot set
    it."""
    steady = [w for w in windows if w <= 1.10 * min(windows)]
    return float(np.median(steady)), len(steady)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_point(W: int, H: int, N: int, capacity: int, n_frames: int,
              n_windows: int, iters_per_window: int, scale_rng=(-4.0, -2.6),
              device=None) -> Point:
    """Steady-state fwd+bwd+Adam step time of the static trainer at one
    point (bench.py:60-169), with the trainer it timed and the kernel
    launches of its timed windows."""
    dev = require_device(device)
    work = build_workload(W, H, N, capacity, n_frames, scale_rng, dev)
    trainer, batch_for = work.trainer, work.batch_for

    first, count = WARMUP_ITERATIONS
    for i in range(count):
        trainer.train_iteration(batch_for(i), first + i)
    _sync(dev)

    windows = []
    kernels.reset_launches()
    for w in range(n_windows):
        first = WINDOW_FIRST_ITERATION + w * iters_per_window
        t0 = time.perf_counter()
        for i in range(iters_per_window):
            trainer.train_iteration(batch_for(i), first + i)
        _sync(dev)
        windows.append((time.perf_counter() - t0) / iters_per_window)
    launches = dict(kernels.LAUNCHES)
    step_s, n_steady = steady_median(windows)
    mpix_s = (W * H / 1e6) / step_s

    print(f"[bench] {W}x{H}/{N // 1000}k "
          f"windows_ms={[round(w * 1e3, 1) for w in windows]} "
          f"steady={n_steady}/{len(windows)} "
          f"fragment_profile={trainer.fragment_profile}", file=sys.stderr)
    return Point({
        "mpix_per_s": round(mpix_s, 3),
        "step_ms": round(step_s * 1e3, 2),
        "windows_ms": [round(w * 1e3, 1) for w in windows],
        "n_steady": n_steady,
        "fragment_profile": str(trainer.fragment_profile),
    }, trainer, batch_for, launches)


def measure(W: int, H: int, N: int, capacity: int, n_frames: int,
            n_windows: int, iters_per_window: int, scale_rng=(-4.0, -2.6),
            device=None) -> dict:
    """bench.py's `measure`: {mpix_per_s, step_ms, windows_ms, n_steady,
    fragment_profile} of `run_point`."""
    return run_point(W, H, N, capacity, n_frames, n_windows,
                     iters_per_window, scale_rng, device).result


def host_load() -> float:
    """The 1-minute load average (-1.0 where the system has none), with a
    warning on stderr when it is above half the cores."""
    try:
        load1 = os.getloadavg()[0]
    except OSError:
        return -1.0
    ncpu = os.cpu_count() or 1
    if load1 > 0.5 * ncpu:
        print(f"[bench] WARNING: host loadavg {load1:.1f} on {ncpu} cpus — "
              "expect inflated windows", file=sys.stderr)
    return load1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.bench",
        description="the static train step's fwd+bwd Mpix/s at 512x512/100k "
                    "and 1920x1080/240k (RODYGS_BENCH_SKIP_1080P=1 skips "
                    "the second)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    return parser


def main(argv=None, points: dict | None = None) -> int:
    """The tool. `points`, when given, receives each measured point's
    `Point` under its workload name, for a caller that checks the state
    its windows timed."""
    args = build_parser().parse_args(argv)
    try:
        device = require_device(args.device)
    except RuntimeError as e:
        print(f"[bench] ERROR: {e}; no measurement possible.",
              file=sys.stderr, flush=True)
        return 2
    load1 = host_load()

    points = {} if points is None else points
    name = workload_name(HEADLINE["W"], HEADLINE["H"], HEADLINE["N"])
    points[name] = run_point(**HEADLINE, device=device)
    small = points[name].result
    workloads = {name: small}
    failed = False
    if os.environ.get("RODYGS_BENCH_SKIP_1080P", "0") != "1":
        name = workload_name(FLAGSHIP["W"], FLAGSHIP["H"], FLAGSHIP["N"])
        try:
            points[name] = run_point(**FLAGSHIP, device=device)
            workloads[name] = points[name].result
        except Exception as e:  # the headline point is still reported
            print(f"[bench] 1080p point failed: {e!r}", file=sys.stderr)
            workloads[name] = {"error": repr(e)[:300]}
            failed = True

    print(device_label(device), flush=True)
    print(json.dumps({
        "metric": "train_step_fwd_bwd_mpix_per_s",
        "value": small["mpix_per_s"],
        "unit": "Mpix/s (512x512, 100k gaussians, fwd+bwd+adam)",
        "vs_baseline": round(small["mpix_per_s"] / A100_REFERENCE_MPIX_S, 3),
        "workloads": workloads,
        "host_load1": round(load1, 2),
    }), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
