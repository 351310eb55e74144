"""Steady-state time of the static train step, and where the device spends
it. Port of `scripts/profile_step.py`.

    python -m rodygs_tpu_torch.tools.profile_step [--steps 15] [--windows 5]
        [--width 512 --height 512 --n 100000 --profile lean] [--fwd_only]
        [--no_trace] [--trace_dir DIR] [--min_ms 0.3] [--device cpu]

By default the `bench.py` workload (512x512, 100k gaussians, L1 + D-SSIM,
pose gradients); `--width 1920 --height 1080 --n 240000` is the flagship
size. Times `--windows` windows of `--steps` synchronised train
iterations and prints their median as

    [steady] <ms> ms/step  (<Mpix/s> Mpix/s fwd+bwd+adam)  settled_profile=<p> last_demand=<fragments>

(the line `scripts/ab_report.py` tabulates), then, unless `--no_trace`,
runs `--steps` more iterations under `utils/profiling.trace` (a Chrome
trace and the program's spans and counters, `trace.json` and `spans.json`
in `--trace_dir`, a new temporary directory by default) and prints the
device operators whose total time is at least `--min_ms`, the device's
busy time per step, and from `spans.json` each span's host ms per step
(self ms beside it; device ms for the spans that time the device) and the
counters. `--fwd_only` times forward renders instead (capacity
probe-fitted as the evaluator fits it): ms per frame, FPS and Mpix/s.

The JAX script's persistent compile cache has no counterpart (PyTorch
compiles nothing per process but the CUDA kernels, which
`rodygs_tpu_torch/_build/` keeps).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..models import gaussians as G
from ..render.camera import make_camera
from ..render.compact import fit_capacity, profile_for_demand
from ..render.rasterize import render
from ..train.losses import LossTerm, MultiLoss
from ..train.optim import CameraPoses
from ..train.trainer_static import (FrameBatch, StaticTrainerConfig,
                                    ThreeDGSTrainer)
from ..utils.platform import device_label, resolve_device
from ..utils.profiling import trace

FOV = 0.9
N_FRAMES = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_trainer(width=512, height=512, n=100_000, profile="lean",
                  device=None):
    """bench.py's workload at (width, height, n): a seeded cloud in a store
    of n * 1.31 slots (131,072 at 100k), 8 frames on a +-0.2 rad arc, GT the
    port's render of the initial scene + N(0, 0.05). Returns (trainer,
    batch_for)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    pts = rng.uniform([-2.0, -2.0, 2.5], [2.0, 2.0, 7.0],
                      size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    cap = -(-int(n * 1.31) // 4096) * 4096
    store = G.from_point_cloud(pts, cols, sh_degree=3, capacity=cap,
                               device=dev)
    scales = np.exp(rng.uniform(-4.0, -2.6, size=(cap, 3))).astype(np.float32)
    store = store._replace(params=store.params._replace(
        scaling=torch.tensor(np.log(scales), device=dev)))

    angles = np.linspace(-0.2, 0.2, N_FRAMES)
    poses = CameraPoses(
        q_c2w=torch.tensor([[np.cos(a / 2), 0, np.sin(a / 2), 0]
                            for a in angles], dtype=torch.float32, device=dev),
        t_c2w=torch.tensor([[np.sin(a) * 4.0, 0, 0] for a in angles],
                           dtype=torch.float32, device=dev))
    loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                      LossTerm("d_ssim", 0.2, "SSIMLoss")])
    cfg = StaticTrainerConfig(
        image_width=width, image_height=height, sh_degree=3,
        densification_interval=0, densify_from_iter=10**9,
        camera_rotation_lr=1e-5, camera_translation_lr=1e-6)
    trainer = ThreeDGSTrainer(cfg, loss, store, poses, spatial_lr_scale=4.0,
                              device=dev)
    trainer.fragment_profile = profile

    gt_rng = np.random.default_rng(11)
    gts = []
    p = store.params
    with torch.no_grad():
        for i in range(N_FRAMES):
            cam = make_camera(poses.q_c2w[i], poses.t_c2w[i], FOV, FOV, 0.0,
                              device=dev)
            img = render(p.xyz, G.get_features(p), G.get_opacity(p),
                         G.get_scaling(p), p.rotation, cam, 3, width, height,
                         alive=store.alive)["rendered_image"].cpu().numpy()
            img = np.clip(img + gt_rng.normal(0, 0.05, img.shape), 0.0, 1.0)
            gts.append(torch.tensor(img, dtype=torch.float32, device=dev))
    batches = [FrameBatch(gt_image=gts[i], gt_depth=None, motion_mask=None,
                          frame_idx=i, time=torch.tensor(0.0, device=dev),
                          fovx=torch.tensor(FOV, device=dev),
                          fovy=torch.tensor(FOV, device=dev))
               for i in range(N_FRAMES)]
    return trainer, (lambda i: batches[i % N_FRAMES])


def timed_window(trainer, batch_for, steps: int, base_iter: int):
    """ms per step of one window of `steps` iterations (synchronised at its
    end), and the last metrics."""
    _sync(trainer.device)
    t0 = time.perf_counter()
    for i in range(steps):
        m = trainer.train_iteration(batch_for(i), base_iter + i)
    float(m["loss"])
    _sync(trainer.device)
    return (time.perf_counter() - t0) / steps * 1e3, m


def top_device_ops(prof, steps: int, min_ms: float) -> float:
    """Print the device operators by total time (>= min_ms over the traced
    steps) and return the device's busy ms per step."""
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    print(f"\n== device ops by total ms over {steps} steps ==")
    shown = 0.0
    for e in sorted(events, key=dev_us, reverse=True):
        ms = dev_us(e) / 1e3
        if ms < min_ms:
            continue
        shown += ms
        print(f"{ms:9.3f} ms  x{e.count:<5d} {e.key[:110]}")
    print(f"[total shown: {shown:.1f} ms; device busy {busy / steps:.3f} "
          f"ms/step]", flush=True)
    return busy / steps


def print_spans(spans_json: Path) -> None:
    """Each span's host ms per step (self ms, device ms where timed), and
    the counters, from a `spans.json` of `utils/profiling.trace`."""
    rec = json.loads(spans_json.read_text())
    n = max(rec["iterations"], 1)
    print(f"\n== program spans per step over {rec['iterations']} steps "
          f"({spans_json}) ==")
    for name, s in sorted(rec["spans"].items(), key=lambda kv:
                          -kv[1]["host_ms"]):
        dev = ("" if s["device_ms"] is None
               else f"  device {s['device_ms'] / n:9.3f} ms")
        print(f"{name} {s['host_ms'] / n:9.3f} ms host, self "
              f"{s['self_host_ms'] / n:9.3f} ms, x{s['calls'] / n:g}{dev}")
    counters = rec["counters"]
    for name, total in sorted(counters.items()):
        print(f"[counter] {name} {total / n:g} per step")
    if counters.get("fragment_slots"):
        fill = 100.0 * counters["fragments"] / counters["fragment_slots"]
        print(f"[fragment fill {fill:.2f}% of the sorted slots]", flush=True)


def run_fwd_only(args, trainer) -> float:
    """Forward-only renders of the scene (a render service's view): the
    capacity probe-fitted as the evaluator fits it (escalate until clean,
    then fit to the demand), then windows of single-frame renders. Returns
    the median ms per frame."""
    W, H = args.width, args.height
    store, poses = trainer.state.store, trainer.state.poses
    f = int(poses.q_c2w.shape[0])
    p = store.params
    dev = trainer.device

    @torch.no_grad()
    def fwd(i, profile):
        cam = make_camera(poses.q_c2w[i % f], poses.t_c2w[i % f], FOV, FOV,
                          0.0, device=dev)
        out = render(p.xyz, G.get_features(p), G.get_opacity(p),
                     G.get_scaling(p), p.rotation, cam, 3, W, H,
                     alive=store.alive, fragment_profile=profile,
                     include_normal=False)
        return out["rendered_image"], out["overflow"], out["num_fragments"]

    profile = trainer.fragment_profile
    while True:
        _, overflow, demand = fwd(0, profile)
        if not bool(overflow):
            fit = fit_capacity(G.capacity_of(store), int(demand))
            profile = fit if isinstance(profile, str) else min(fit, profile)
            break
        wider = profile_for_demand(G.capacity_of(store), int(demand), profile)
        if wider is None:
            break
        profile = wider
    fwd(0, profile)
    wins = []
    for w in range(args.windows):
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(args.steps):
            img, _, _ = fwd(i, profile)
        _sync(dev)
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        wins.append(ms)
        print(f"[fwd window {w}] {ms:.2f} ms/frame", flush=True)
    med = float(np.median(wins))
    print(f"[fwd steady] {med:.2f} ms/frame = {1e3 / med:.1f} FPS "
          f"({W * H / 1e6 / (med / 1e3):.2f} Mpix/s fwd-only)  "
          f"capacity={profile}", flush=True)
    return med


def main(args) -> float:
    """Returns the steady ms per step (per frame with --fwd_only)."""
    device = resolve_device(args.device)
    print(f"[profile_step] {args.width}x{args.height}, {args.n} gaussians on "
          f"{device_label(device)}", flush=True)
    profile = int(args.profile) if args.profile.isdigit() else args.profile
    trainer, batch_for = build_trainer(args.width, args.height, args.n,
                                       profile, device)
    if args.fwd_only:
        return run_fwd_only(args, trainer)
    for i in range(3):  # warm-up: the kernels' first launches
        m = trainer.train_iteration(batch_for(i), 1000 + i)
    float(m["loss"])

    wins = []
    for w in range(args.windows):
        ms, m = timed_window(trainer, batch_for, args.steps,
                             2000 + w * args.steps)
        wins.append(ms)
        print(f"[window {w}] {ms:.1f} ms/step", flush=True)
    med = float(np.median(wins))
    mpix = args.width * args.height / 1e6 / (med / 1e3)
    settled = str(trainer.fragment_profile).replace(" ", "")
    print(f"[steady] {med:.1f} ms/step  ({mpix:.2f} Mpix/s fwd+bwd+adam)  "
          f"settled_profile={settled} "
          f"last_demand={int(m['num_fragments'])}", flush=True)

    if not args.no_trace:
        logdir = Path(args.trace_dir or tempfile.mkdtemp(
            prefix="profile_step_"))
        with trace(str(logdir)) as prof:
            for i in range(args.steps):
                m = trainer.train_iteration(batch_for(i), 5000 + i)
            float(m["loss"])
            _sync(device)
        top_device_ops(prof, args.steps, args.min_ms)
        print_spans(logdir / "spans.json")
    return med


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.profile_step",
        description="Steady-state train-step time and the device's top ops.")
    p.add_argument("--steps", type=int, default=15)
    p.add_argument("--windows", type=int, default=5,
                   help="timed windows for the steady-state median")
    p.add_argument("--fwd_only", action="store_true",
                   help="serving throughput: forward-only renders (FPS)")
    p.add_argument("--no_trace", action="store_true",
                   help="timing only (A/B runs; skips the profiler)")
    p.add_argument("--trace_dir", default=None,
                   help="where trace.json and spans.json go (default: a "
                        "new temporary directory)")
    p.add_argument("--min_ms", type=float, default=0.3)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--profile", default="lean",
                   help="fragment profile (lean/wide/huge or an integer)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
