#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. build   — compile the four CUDA kernels of rodygs_tpu_torch/csrc from
               source (one nvcc per file, in parallel); print the seconds,
               ptxas's registers and shared memory, and the blocks of each
               tile kernel that one SM holds (the CUDA runtime's count).
  2. check   — on a 128x128, 5k-gaussian render's own binning (tight=True
               and tight="rows"), hold every kernel against its plain
               PyTorch version on the card, and a full CUDA render against
               the same render on the CPU. Then the inputs the tile
               kernels' parts fear: needles and blobs with opacities on
               both sides of 1/255 (the cull's margin), hand-made tiles of
               0, 32, 33, 64, 65 and 2,100 fragments (batch edges), the
               second half of the tile grid under tile_id_offset = T/2,
               both include_normal settings, and the backward twice on the
               same inputs for equal bits.
  3. train   — the bench.py workload through the port's public entry
               points: 512x512, 100k points in a 131,072-slot store, SH 3,
               8 frames, L1 0.8 + D-SSIM 0.2, camera lr 1e-5 / 1e-6, 200
               `train_iteration`s from iteration 1, so the capacity
               poller's initial fit (iteration 5) and its steady-state
               polls (125-200) run before the steps that are timed; the
               profile's changes and each frame's demand are printed.
               Launch counters are zeroed just before and read just
               after; asserts the loss falls, pose gradients are non-zero,
               every kernel launched and the capacity profile kept 1 band.
               Prints step_ms (median of the last 10 synchronised steps),
               the spread of the last 50, and Mpix/s.
  4. profile — torch.profiler over 5 more steps: device time by kernel
               and the device's busy share of the wall time.
  5. time    — each kernel, its plain version and (segsum) the one-call
               library equivalent `index_add_`, timed with CUDA events at
               the shapes of the trained state's render; the least time
               (bound) from the bytes and operations of this run's inputs;
               the tile-count distribution and the (warp, fragment) pair
               counts of that render (`kernel_check.walk_stats`).
  6. report  — the card's name and power limit (nvidia-smi), one JSON line
               of per-kernel numbers, and last {"ok": true, "device": ...}.

Without CUDA, or run from a directory without the package, it exits with
a non-zero code before printing any result. Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP32
# (non-tensor-core) rate; the kernels do FP32 arithmetic outside the tensor
# cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# FP32 operations per evaluated (pixel, fragment) pair, an FMA counting as
# two and a transcendental as one. Every evaluated pair: offsets 2, conic
# form 9, negate and exp 2, opacity product 1, clamp 1, two tests 2 => 17;
# that is all a rejected pair costs (sigma < 0, alpha < 1/255, or the one
# that stops the pixel). A contributing pair adds, forward: log1p, add,
# stop test, the transmittance (an exp or a product step), weight 5 and the
# 8-channel accumulate 16 => 38; backward: the same 5, f.g 16, prefix 2,
# suffix 1, d_alpha 4, clamp select 1, d_sigma 2, the six geometry grads 19,
# 8 feature grads 8 and the 14-value pixel reduction 14 => 89.
# Without the normal rows (the trainer's renders) five channels are live and
# the alpha feature is the constant 1: the accumulate is 4 FMAs and an add,
# 9 => 31; backward f.g is 9, the feature grads 5 and the reduction 11 => 76.
# The rejected pairs are counted as the cheapest known correct walk needs
# them (`rejected_ops`): every pair a pixel rejects at 17, or one rectangle
# test per (warp, fragment) of the tile's walk and 17 for the rejected pairs
# inside the (warp, fragment) pairs the test keeps. The test
# (csrc/tile_common.cuh::rect_may_take): opacity and convexity 8, offsets
# and the inside test 8, two quotients 4, four clamped edge minima of the
# form 51, the margin's magnitude 16, log and compare 6 => 93.
# The work the function needs, whatever implements it.
REJECTED_OPS_PER_PAIR = 17
CULL_OPS_PER_TEST = 93
FWD_OPS_PER_CONTRIB = {True: 38, False: 31}
BWD_OPS_PER_CONTRIB = {True: 89, False: 76}

SOURCES = {
    "expand": ("rodygs_tpu_torch/csrc/expand.cu",
               "rodygs_tpu/render/compact.py:769"),
    "tile_fwd": ("rodygs_tpu_torch/csrc/tile_fwd.cu",
                 "rodygs_tpu/render/tile_kernel.py:360"),
    "tile_bwd": ("rodygs_tpu_torch/csrc/tile_bwd.cu",
                 "rodygs_tpu/render/tile_kernel.py:401"),
    "segsum": ("rodygs_tpu_torch/csrc/segsum.cu",
               "rodygs_tpu/render/compact.py:850"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rejected_ops(contrib, rejected, warp_pairs):
    """Operations the rejected (pixel, fragment) pairs need at the least:
    the smaller of the per-pixel walk (every rejected pair evaluated) and,
    for each warp shape, a culled walk (one rectangle test per (warp,
    fragment) of the tile's walk, then only the lanes of kept pairs)."""
    counts = {"per pixel": REJECTED_OPS_PER_PAIR * rejected}
    for shape, n in warp_pairs.items():
        counts[f"culled {shape}"] = (
            CULL_OPS_PER_TEST * n["block_walk"]
            + REJECTED_OPS_PER_PAIR * (n["kept_lanes"] - contrib))
    walk = min(counts, key=counts.get)
    log("[time] operations for the rejected pairs: " + " ".join(
        f"{k}={v}" for k, v in counts.items()) + f"; the bound takes {walk!r}")
    return counts[walk]


def time_kernels(s):
    """{kernel: dict(ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render import tile_kernel as TK

    cb = s["cb"]
    tab, bases, fk = s["table"], cb.bases, cb.f_kept
    cap = bases.shape[0] * C.FCHUNK
    n_kept = int(fk)
    args = (s["records"], cb.tile_starts, cb.tile_counts, s["off"])
    normals = s["include_normal"]
    p_cols = s["records"].shape[1]
    num_tiles = cb.tile_starts.shape[0]
    plane_bytes = num_tiles * TK.PIX * 4
    # the compositors read the used rows of the fragments in tile ranges:
    # 6 geometry rows and the live feature rows (the alpha feature is a
    # constant without normals)
    n_live = 8 if normals else 5
    rec_bytes = ((14 if normals else 10) * int(cb.tile_counts.sum()) * 4
                 + num_tiles * 8)
    contrib, rejected = KC.needed_pairs(s)
    stats = KC.walk_stats(s)
    ops_rejected = rejected_ops(contrib, rejected, stats["warp_pairs"])
    d = s["d_presort"]
    n_rows, nw = d.shape[0], tab.shape[1]
    # segsum reads only the f_kept filled slots; so does the library call
    d_kept = d[:, :n_kept]
    owner = torch.searchsorted(
        tab[C.ROW_OFF], torch.arange(n_kept, device=d.device,
                                     dtype=torch.float32), right=True) - 1
    res = {}

    b, by = bound(tab.numel() * 4 + bases.numel() * 4 + cap * 4 * 14, 0)
    res["expand"] = dict(
        ms=time_ms(lambda: C.expand_fragments(tab, bases, fk, s["tx"], s["db"])),
        plain_ms=time_ms(lambda: C.expand_fragments_plain(
            tab, bases, fk, s["tx"], s["db"]), reps=3),
        library_ms=None, bound_ms=b, bound_by=by)
    # forward: all 8 planes are written; backward: the live planes of O and
    # g are read and all 16 rows of d_records written
    b, by = bound(rec_bytes + 8 * plane_bytes,
                  FWD_OPS_PER_CONTRIB[normals] * contrib + ops_rejected)
    res["tile_fwd"] = dict(
        ms=time_ms(lambda: TK.rasterize_fwd_impl(*args, s["tx"], normals)),
        plain_ms=time_ms(lambda: TK.rasterize_fwd_plain(*args, s["tx"],
                                                        normals), reps=2),
        library_ms=None, bound_ms=b, bound_by=by)
    b, by = bound(rec_bytes + 2 * n_live * plane_bytes + 16 * p_cols * 4,
                  BWD_OPS_PER_CONTRIB[normals] * contrib + ops_rejected)
    res["tile_bwd"] = dict(
        ms=time_ms(lambda: TK.rasterize_bwd_impl(*args, s["out"], s["gout"],
                                                 s["tx"], normals)),
        plain_ms=time_ms(lambda: TK.rasterize_bwd_plain(
            *args, s["out"], s["gout"], s["tx"], normals), reps=2),
        library_ms=None, bound_ms=b, bound_by=by)
    # the heaviest tile alone: what one block's serial walk takes, the floor
    # of any one-block-per-tile design on this data
    heavy = int(cb.tile_counts.argmax())
    h_args = (s["records"], cb.tile_starts[heavy:heavy + 1].contiguous(),
              cb.tile_counts[heavy:heavy + 1].contiguous(),
              torch.tensor([heavy], dtype=torch.int32, device=d.device))
    h_out = s["out"][heavy:heavy + 1].contiguous()
    h_gout = s["gout"][heavy:heavy + 1].contiguous()
    log(f"[time] heaviest tile alone ({int(cb.tile_counts[heavy])} "
        f"fragments, one block): tile_fwd "
        f"{time_ms(lambda: TK.rasterize_fwd_impl(*h_args, s['tx'], normals)):.4f}"
        f" ms, tile_bwd "
        f"{time_ms(lambda: TK.rasterize_bwd_impl(*h_args, h_out, h_gout, s['tx'], normals)):.4f}"
        f" ms (with its zero fill)")
    log(f"[time] zero fill of d_records [16, {p_cols}] inside tile_bwd's "
        f"wrapper: {time_ms(lambda: torch.zeros_like(s['records'])):.4f} ms")
    b, by = bound(n_rows * n_kept * 4 + nw * 4 + n_rows * nw * 4,
                  n_rows * n_kept)
    res["segsum"] = dict(
        ms=time_ms(lambda: C.segment_sum_rows(d, tab, fk)),
        plain_ms=time_ms(lambda: C.segment_sum_rows_plain(d, tab, fk), reps=5),
        library_ms=time_ms(lambda: torch.zeros(
            (n_rows, nw), device=d.device).index_add_(1, owner, d_kept)),
        bound_ms=b, bound_by=by)
    log(f"[time] C={cap} P={p_cols} tiles={num_tiles} f_kept={n_kept} "
        f"include_normal={normals} pairs: contributing={contrib} "
        f"rejected={rejected}")
    for k in ("tile_counts", "tile_walked"):
        log(f"[time] {k} (fragments per tile): " + " ".join(
            f"{n}={v:.1f}" for n, v in stats[k].items()))
    for shape, n in stats["warp_pairs"].items():
        log(f"[time] (warp, fragment) pairs, warp = {shape} "
            f"{TK.WARP_SHAPES[shape]}: " + " ".join(
                f"{k}={v}" for k, v in n.items()))
    return res


def occupancy_lines(build_log):
    """ptxas's register, spill and shared-memory lines of every kernel, and
    the blocks of each tile kernel one SM holds: the runtime's count from
    registers, static and dynamic shared memory and threads."""
    from rodygs_tpu_torch import kernels

    lines = []
    for name, text in build_log.items():
        entry = name
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:   # the template argument, ILb0E / ILb1E, tells the two apart
                entry = f"{name}<{m.group(1)}>"
            if "registers" in line or "spill" in line:
                lines.append(f"[build] {entry}: {line.strip()}")
    for name in ("tile_fwd", "tile_bwd"):
        for normals in (False, True):
            blocks = kernels.blocks_per_sm(name, normals)
            require(blocks > 0, f"{name} does not fit an SM")
            lines.append(f"[build] {name} include_normal={normals}: {blocks} "
                         f"resident blocks of 256 threads per SM")
    return lines


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_check(device):
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.rasterize import render

    from rodygs_tpu_torch.render import tile_kernel as TK

    errs = {}

    def keep(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    params, cam = KC.random_scene(5000, 3, device, log_scale=(-4.0, -2.6))
    for tight in (True, "rows"):
        s = KC.capture_stages(params, None, cam, 3, 128, 128, "lean", tight, 1)
        e = KC.check_stages(s)
        log(f"[check] 128x128 n=5000 tight={tight!r} "
            f"fragments={int(s['cb'].num_fragments)} max_abs_err={e}")
        keep(e)

    # the second half of the tile grid alone, under tile_id_offset = T/2
    cb, half = s["cb"], s["cb"].tile_starts.shape[0] // 2
    off = torch.tensor([half], dtype=torch.int32, device=device)
    args = (s["records"], cb.tile_starts[half:].contiguous(),
            cb.tile_counts[half:].contiguous(), off)
    e = KC.check_tiles(*args, s["tx"], False)
    out = TK.rasterize_fwd_impl(*args, s["tx"], False)
    require(torch.equal(out, s["out"][half:]),
            "tile_fwd under tile_id_offset differs from the whole render")
    log(f"[check] tile_id_offset={half}: max_abs_err={e}, forward equal to "
        f"the whole render's second half")
    keep(e)

    # needles and blobs, opacities on both sides of 1/255: the cull's margin
    nb_params, nb_cam = KC.random_scene(5000, 3, device, log_scale=(-6.0, -1.0),
                                        opacity=(0.004, 0.99))
    for include_normal in (False, True):
        s = KC.capture_stages(nb_params, None, nb_cam, 3, 128, 128, "lean",
                              True, 1, include_normal=include_normal)
        e = KC.check_stages(s)
        log(f"[check] needles and blobs include_normal={include_normal} "
            f"fragments={int(s['cb'].num_fragments)} max_abs_err={e}")
        keep(e)

    # batch edges: tiles of 0, one batch, one more, and over 2,000 fragments
    counts = [0, 32, 33, 64, 65, 1, 2100, 0, 31, 129, 2500, 64]
    rec, starts, cnts, off = KC.synthetic_tiles(counts, 4, device, 4)
    for include_normal in (False, True):
        if include_normal:
            gen = torch.Generator(device=device).manual_seed(2)
            rec[10:14] = torch.rand((4, rec.shape[1]), generator=gen,
                                    device=device)
        e = KC.check_tiles(rec, starts, cnts, off, 4, include_normal)
        log(f"[check] tile counts {counts} include_normal={include_normal}: "
            f"max_abs_err={e}; tile backward twice: equal bits")
        keep(e)

    # the whole render on the card against the same render on the CPU
    with torch.no_grad():
        args = lambda p: (p.xyz, G.get_features(p), G.get_opacity(p),
                          G.get_scaling(p), p.rotation)
        gpu = render(*args(params), cam, 3, 128, 128)
        cpu_params = type(params)(*[x.cpu() for x in params])
        cpu_cam = type(cam)(*[x.cpu() for x in cam])
        ref = render(*args(cpu_params), cpu_cam, 3, 128, 128)
    for k in ("rendered_image", "rendered_alpha", "rendered_depth"):
        e = float((gpu[k].cpu() - ref[k]).abs().max())
        tol = 2e-4 if k == "rendered_depth" else 1e-4
        log(f"[check] render cuda vs cpu {k}: max_abs_err={e:.3g} (tol {tol})")
        require(math.isfinite(e) and e <= tol, f"render {k} differs: {e}")
    return errs


def bench_trainer(device, size=512, N=100_000, capacity=131072):
    """bench.py's 512^2 / 100k workload, built through the port."""
    import torch
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.camera import make_camera
    from rodygs_tpu_torch.render.rasterize import render
    from rodygs_tpu_torch.train.losses import LossTerm, MultiLoss
    from rodygs_tpu_torch.train.optim import CameraPoses
    from rodygs_tpu_torch.train.trainer_static import (
        FrameBatch, StaticTrainerConfig, ThreeDGSTrainer)

    W = H = size
    n_frames, fov = 8, 0.9
    rng = np.random.default_rng(7)
    pts = rng.uniform([-2.0, -2.0, 2.5], [2.0, 2.0, 7.0],
                      size=(N, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(N, 3)).astype(np.float32)
    store = G.from_point_cloud(pts, cols, sh_degree=3, capacity=capacity,
                               device=device)
    scales = np.exp(rng.uniform(-4.0, -2.6, size=(capacity, 3))).astype(np.float32)
    store = store._replace(params=store.params._replace(
        scaling=torch.tensor(np.log(scales), device=device)))
    qs, ts = [], []
    for ang in np.linspace(-0.2, 0.2, n_frames):
        qs.append([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        ts.append([np.sin(ang) * 4.0, 0, 0])
    poses = CameraPoses(q_c2w=torch.tensor(qs, dtype=torch.float32, device=device),
                        t_c2w=torch.tensor(ts, dtype=torch.float32, device=device))
    loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                      LossTerm("d_ssim", 0.2, "SSIMLoss")])
    cfg = StaticTrainerConfig(
        image_width=W, image_height=H, sh_degree=3,
        densification_interval=0, densify_from_iter=10**9,
        camera_rotation_lr=1e-5, camera_translation_lr=1e-6)
    trainer = ThreeDGSTrainer(cfg, loss, store, poses, spatial_lr_scale=4.0,
                              device=device)
    gt_rng = np.random.default_rng(11)
    gts = []
    p = store.params
    with torch.no_grad():
        for i in range(n_frames):
            cam = make_camera(poses.q_c2w[i], poses.t_c2w[i], fov, fov, 0.0,
                              device=device)
            img = render(p.xyz, G.get_features(p), G.get_opacity(p),
                         G.get_scaling(p), p.rotation, cam, 3, W, H,
                         alive=store.alive)["rendered_image"].cpu().numpy()
            img = np.clip(img + gt_rng.normal(0, 0.05, img.shape), 0.0, 1.0)
            gts.append(torch.tensor(img, dtype=torch.float32, device=device))

    def batch_for(i):
        return FrameBatch(gt_image=gts[i % n_frames], gt_depth=None,
                          motion_mask=None, frame_idx=i % n_frames,
                          time=torch.tensor(0.0, device=device),
                          fovx=torch.tensor(fov, device=device),
                          fovy=torch.tensor(fov, device=device))

    return trainer, batch_for, (W, H)


def phase_train(device, iterations=200, **scene):
    import torch
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.render.compact import split_profile

    t0 = time.perf_counter()
    trainer, batch_for, (W, H) = bench_trainer(device, **scene)
    torch.cuda.synchronize()
    log(f"[train] set-up {time.perf_counter() - t0:.2f} s")
    poses0 = [x.clone() for x in trainer.state.poses]

    losses, step_s, frags, profiles = [], [], [], []
    kernels.reset_launches()
    for it in range(1, iterations + 1):
        t = time.perf_counter()
        m = trainer.train_iteration(batch_for(it - 1), it)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        frags.append(int(m["num_fragments"]))
        if not profiles or profiles[-1][1] != trainer.fragment_profile:
            profiles.append((it, trainer.fragment_profile))
    launches = dict(kernels.LAUNCHES)
    log(f"[train] launches on the main path: {launches}")
    log(f"[train] capacity profile from iteration: {profiles}; fragment "
        f"demand of the 8 frames, first pass {frags[:8]}, last pass "
        f"{frags[-8:]}")

    require(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    log(f"[train] loss first-8 mean {first:.6f} -> last-8 mean {last:.6f}")
    require(last < first, "loss did not fall")
    moved = [float((a - b).abs().max())
             for a, b in zip(trainer.state.poses, poses0)]
    log(f"[train] pose change max |dq| {moved[0]:.3g} |dt| {moved[1]:.3g}")
    _, _, (_, g_poses, _) = trainer.loss_and_grads(
        trainer.state, batch_for(0), trainer.loss.active_set(iterations),
        trainer.active_sh_degree, trainer.fragment_profile)
    gq, gt = (float(g.abs().max()) for g in g_poses)
    log(f"[train] pose grad max |g_q| {gq:.3g} |g_t| {gt:.3g}")
    require(gq > 0 and gt > 0 and min(moved) > 0, "pose gradients are zero")
    require(all(launches[k] > 0 for k in kernels.KERNELS),
            f"a kernel never launched on the main path: {launches}")
    require(split_profile(trainer.fragment_profile)[1] == 1,
            f"profile left 1 band: {trainer.fragment_profile}")
    step_ms = float(np.median(step_s[-10:]) * 1e3)
    last50 = np.asarray(step_s[-50:]) * 1e3
    log(f"[train] {iterations} iterations; step_ms={step_ms:.3f} "
        f"(median of the last 10, synchronised) "
        f"mpix_per_s={W * H / 1e6 / (step_ms / 1e3):.3f} "
        f"last-50 median {np.median(last50):.3f} min {last50.min():.3f} "
        f"p90 {np.percentile(last50, 90):.3f} max {last50.max():.3f} "
        f"num_fragments={frags[-1]} settled_profile={trainer.fragment_profile!r}")
    log(f"[train] step_ms_all={[round(x * 1e3, 2) for x in step_s]}")
    return trainer, batch_for, launches, iterations


def phase_profile(trainer, batch_for, first_iteration, steps=5):
    """torch.profiler over a few steps: device time by kernel/op (self
    time, per step) and the device's busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()   # after the profiler's own start-up
        for it in range(first_iteration, first_iteration + steps):
            trainer.train_iteration(batch_for(it - 1), it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: the CPU-op rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    require(total_ms > 0, "the profiler saw no device time")
    log(f"[profile] {steps} steps: wall {wall_ms:.3f} ms/step (profiler on), "
        f"device busy {total_ms:.3f} ms/step = "
        f"{100 * total_ms / wall_ms:.1f}% of wall")
    for e in sorted(events, key=dev_us, reverse=True)[:14]:
        ms = dev_us(e) / 1e3 / steps
        log(f"[profile]   {ms:8.4f} ms/step {100 * ms / total_ms:5.1f}%  "
            f"x{e.count // steps:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rodygs_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    from rodygs_tpu_torch.utils.platform import resolve_device

    device = resolve_device("cuda")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    secs = kernels.build_all()
    log(f"[build] {secs:.2f} s")
    for line in occupancy_lines(kernels.BUILD_LOG):
        log(line)

    errs = phase_check(device)
    trainer, batch_for, launches, iterations = phase_train(device)
    phase_profile(trainer, batch_for, first_iteration=iterations + 1)

    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    st = trainer.state
    cam = make_camera_from_poses(st.poses, batch_for(0))
    s = KC.capture_stages(st.store.params, st.store.alive, cam,
                       trainer.active_sh_degree, 512, 512,
                       trainer.fragment_profile, _default_tight(32 * 32), 2)
    e512 = KC.check_stages(s)
    log(f"[check] 512x512 trained state max_abs_err={e512}")
    timings = time_kernels(s)

    rows = []
    for name in kernels.KERNELS:
        src, replaces = SOURCES[name]
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(errs[name], e512[name]),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        log(f"[time] {name}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), launches in "
            f"{iterations} steps "
            f"{launches[name]}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
