"""Scaling efficiency: rays/s against the rank count over mesh shapes. Port
of `scripts/scaling_bench.py`.

    RODYGS_DIST_BACKEND=nccl torchrun --standalone --nproc_per_node N \\
        -m rodygs_tpu_torch.tools.scaling_bench [--width 512 --height 512
        --gaussians 100000 --iters 20 --fragment_profile lean] [--no_gauss]
        [--meshes dxgxt,...] [--out SCALING.json] [--device cpu]

One process per rank, under torchrun or the RODYGS_COORDINATOR /
RODYGS_NUM_PROCESSES / RODYGS_PROCESS_ID contract (parallel/multihost.py;
RODYGS_DIST_BACKEND states the backend: `nccl` for one card per rank,
`gloo` for the CPU or ranks that share a card); run alone it is a world of
one. The sweep runs every (data, gauss, tile) factorisation of the rank
count (or `--meshes`), each after the 1-rank baseline, through the port's
sharded static step (`parallel.sharded.make_sharded_static_step`: render
forward + backward, Adam, pose optimisation; the store interleaved over
the gauss blocks) on the JAX script's seeded scene, and reports per mesh

    rays_per_s = data * W * H / step time     (the data axis renders that
                                               many frames per step)
    efficiency = rays_per_s / (rays_per_s of the baseline * ranks used)

A mesh of fewer ranks than the world (the baseline) runs on the first
ranks while the others wait. Each rank times `--iters` steps after one
warm-up step (which raises on a fragment overflow) on its own card,
synchronised; the mesh's step time is the slowest rank's (an all-reduce
MAX). A mesh that fails is reported in its row and the sweep goes on, but
the tool then exits non-zero. The primary alone writes `--out`; every row
and the summary are printed, after each rank's card name and power limit.
`--fragment_profile` takes a ladder name or a capacity in fragments.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..models import gaussians as G
from ..parallel.collectives import pmax
from ..parallel.mesh import make_mesh, rank_device
from ..parallel.multihost import (is_primary, maybe_initialize_distributed,
                                  process_count)
from ..parallel.sharded import (make_sharded_static_step, stack_batches,
                                static_state_block)
from ..render.compact import MAX_FRAGMENT_CAPACITY, profile_for_demand
from ..render.rasterize import render
from ..train.losses import LossTerm, MultiLoss
from ..train.optim import CameraPoses
from ..train.trainer_static import (FrameBatch, StaticTrainerConfig,
                                    init_static_state, make_camera_from_poses)
from ..utils.platform import device_label, resolve_device


def candidate_meshes(n_devices: int, include_gauss: bool = True):
    """All (data, gauss, tile) factorisations of n_devices, deduplicated,
    plus the 1-device baseline first."""
    shapes = {(1, 1, 1)}
    for d, g, t in itertools.product(range(1, n_devices + 1), repeat=3):
        if d * g * t == n_devices and (include_gauss or g == 1):
            shapes.add((d, g, t))
    return sorted(shapes, key=lambda s: (s[0] * s[1] * s[2], s))


def build_scene(n: int, width: int, height: int, n_frames: int, seed=0,
                device=None):
    """The JAX script's scene from the same numpy draws: n points in a
    box, SH 3, a store of the next power of two slots (>= 256), n_frames
    identity rotations with seeded translations, uniform-noise GT frames.
    Returns (store, poses, frames)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2.0, -1.5, 2.5], [2.0, 1.5, 7.0],
                      size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    capacity = max(256, 1 << (n - 1).bit_length())
    store = G.from_point_cloud(pts, cols, sh_degree=3, capacity=capacity,
                               device=dev)
    poses = CameraPoses(
        q_c2w=torch.tensor([[1.0, 0, 0, 0]] * n_frames, dtype=torch.float32,
                           device=dev),
        t_c2w=torch.tensor(rng.uniform(-0.15, 0.15, size=(n_frames, 3))
                           .astype(np.float32), device=dev))
    frames = []
    for i in range(n_frames):
        gt = rng.uniform(size=(height, width, 3)).astype(np.float32)
        frames.append(FrameBatch(
            gt_image=torch.tensor(gt, device=dev), gt_depth=None,
            motion_mask=None, frame_idx=i,
            time=torch.tensor(0.0, device=dev),
            fovx=torch.tensor(0.9, device=dev),
            fovy=torch.tensor(0.7, device=dev)))
    return store, poses, frames


def static_setup(width: int, height: int):
    """(config, loss) of the benchmarked step: L1 0.8 + D-SSIM 0.2, SH 3,
    camera lr 1e-5 / 1e-6."""
    loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                      LossTerm("d_ssim", 0.2, "SSIMLoss")])
    cfg = StaticTrainerConfig(
        image_width=width, image_height=height, sh_degree=3,
        camera_rotation_lr=1e-5, camera_translation_lr=1e-6)
    return cfg, loss


def mesh_step(shape, store, poses, frames, width: int, height: int,
              device=None):
    """(mesh, step, state, batch) of one (data, gauss, tile) shape on the
    first d*g*t ranks: this rank's gauss block of the initial state and the
    stacked batch of frames 0..d-1. Every rank of the world must call (the
    mesh's groups are made collectively); None on a rank outside the
    mesh."""
    n_data, n_gauss, n_tile = shape
    mesh = make_mesh(n_data=n_data, n_tile=n_tile, n_gauss=n_gauss,
                     device=device, ranks=n_data * n_gauss * n_tile)
    if mesh is None:
        return None
    cfg, loss = static_setup(width, height)
    step = make_sharded_static_step(
        cfg, loss, mesh, spatial_lr_scale=3.0,
        gen=torch.Generator(device=mesh.device).manual_seed(0))
    st = G.shard_interleave(store, n_gauss) if n_gauss > 1 else store
    state = init_static_state(st, poses)
    if n_gauss > 1:
        state = static_state_block(state, mesh)
    batch = stack_batches([frames[i % len(frames)] for i in range(n_data)])
    return mesh, step, state, batch


def fitting_profile(store, demand: int, profile="lean"):
    """`profile` when `demand` fragments fit it, else the narrowest wider
    ladder profile (or grid capacity) that holds them."""
    wider = profile_for_demand(G.capacity_of(store), demand, profile)
    return profile if wider is None else wider


def scene_profile(store, poses, frames, width: int, height: int):
    """(profile, demand): the largest fragment demand of frames 0-3 (those
    the data rows of up to four ranks render), each rendered at the
    largest capacity, and the profile that holds it (`fitting_profile`
    from "lean", the default). Raises when a frame overflows the largest
    capacity."""
    demand = 0
    with torch.no_grad():
        for frame in frames[:4]:
            cam = make_camera_from_poses(poses, frame)
            p = store.params
            out = render(p.xyz, G.get_features(p), G.get_opacity(p),
                         G.get_scaling(p), p.rotation, cam, 3, width, height,
                         alive=store.alive, include_normal=False,
                         fragment_profile=MAX_FRAGMENT_CAPACITY)
            if bool(out["overflow"]):
                raise RuntimeError(f"frame {frame.frame_idx} overflows the "
                                   f"largest fragment capacity")
            demand = max(demand, int(out["num_fragments"]))
    return fitting_profile(store, demand), demand


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_mesh(shape, store, poses, frames, width, height, iters,
               fragment_profile, device=None):
    """Steady-state step seconds of one (data, gauss, tile) mesh shape, the
    slowest rank's, and this rank's (warm-up loss, kernel launches); None
    on a rank outside the mesh."""
    setup = mesh_step(shape, store, poses, frames, width, height, device)
    if setup is None:
        return None
    mesh, step, state, batch = setup
    active = step.loss.active_set(1)
    kernels.reset_launches()
    state2, m = step(state, batch, 1.0, active, 3, fragment_profile)
    if bool(m["overflow"]):
        wider = fitting_profile(store, int(m["num_fragments"]),
                                fragment_profile)
        raise RuntimeError(
            f"fragment overflow at profile={fragment_profile} (demand "
            f"{int(m['num_fragments'])}); rerun with --fragment_profile "
            f"{wider}")
    loss0 = float(m["loss"])
    _sync(mesh.device)
    t0 = time.perf_counter()
    for i in range(iters):
        state2, m = step(state2, batch, float(i + 2), active, 3,
                         fragment_profile)
    float(m["loss"])
    _sync(mesh.device)
    sec = (time.perf_counter() - t0) / iters
    sec = float(pmax(torch.tensor([sec], dtype=torch.float64,
                                  device=mesh.device), mesh.world)[0])
    return sec, loss0, dict(kernels.LAUNCHES)


def _gather(value) -> list:
    """Every rank's `value`, in rank order (a world collective)."""
    if process_count() == 1:
        return [value]
    out = [None] * process_count()
    dist.all_gather_object(out, value)
    return out


def run(args) -> dict:
    """The sweep; returns the summary (with "failed": the meshes that
    failed)."""
    resolve_device(args.device)
    created = not dist.is_initialized() and maybe_initialize_distributed()
    try:
        dev = rank_device(None if args.device == "cuda" else args.device)
        if dev.type == "cuda":
            # NCCL's object collectives run on the current card: this
            # rank's, before the first of them
            torch.cuda.set_device(dev)
        n_dev = process_count()
        label = device_label(dev)
        for rank, (lab, backend) in enumerate(_gather(
                (label, dist.get_backend() if dist.is_initialized()
                 else "none"))):
            if is_primary():
                print(f"[scaling] rank {rank}: {lab} ({backend})", flush=True)
        if is_primary():
            print(f"[scaling] {n_dev} ranks, {args.width}x{args.height}, "
                  f"{args.n} gaussians", flush=True)
        if args.meshes:
            shapes = [(1, 1, 1)] + [tuple(int(x) for x in s.split("x"))
                                    for s in args.meshes.split(",")]
        else:
            shapes = candidate_meshes(n_dev, include_gauss=not args.no_gauss)
        store, poses, frames = build_scene(args.n, args.width, args.height,
                                           n_frames=max(8, n_dev), device=dev)
        profile = args.fragment_profile
        profile = int(profile) if profile.isdigit() else profile

        results, failed = [], []
        base_rays = None
        for shape in shapes:
            n_data, n_gauss, n_tile = shape
            mesh_key = {"data": n_data, "gauss": n_gauss, "tile": n_tile}
            try:
                mine = bench_mesh(shape, store, poses, frames, args.width,
                                  args.height, args.iters, profile, dev)
                err = None
            except Exception as e:  # a shape may not fit: report it, go on
                mine, err = None, repr(e)[:300]
            every = _gather((mine, err))
            errors = [f"rank {r}: {e}" for r, (_, e) in enumerate(every)
                      if e]
            if errors:
                if is_primary():
                    print(f"[scaling] mesh d{n_data}xg{n_gauss}xt{n_tile} "
                          f"FAILED: {errors[0][:160]}", flush=True)
                results.append({"mesh": mesh_key, "error": "; ".join(errors)})
                failed.append(mesh_key)
                continue
            ran = [m for m, _ in every if m is not None]
            sec = ran[0][0]
            rays = n_data * args.width * args.height / sec
            used = n_data * n_gauss * n_tile
            if shape == (1, 1, 1):
                base_rays = rays
            eff = (rays / (base_rays * used)) if base_rays else None
            row = {"mesh": mesh_key,
                   "step_ms": round(sec * 1e3, 2),
                   "rays_per_s": round(rays),
                   "efficiency": round(eff, 4) if eff is not None else None,
                   "first_loss": [m[1] for m in ran],
                   "launches": [m[2] for m in ran]}
            results.append(row)
            if is_primary():
                print(f"[scaling] {json.dumps(row)}", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        summary = {
            "n_devices": n_dev,
            "platform": dev.type,
            "device": label,
            "workload": f"{args.width}x{args.height}, {args.n} gaussians, "
                        "sharded static step (render fwd+bwd + adam + pose)",
            "iters": args.iters,
            "fragment_profile": profile,
            "baseline_rays_per_s": round(base_rays) if base_rays else None,
            "meshes": results,
            "failed": failed,
        }
        if is_primary():
            print(json.dumps(summary), flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
                print(f"[scaling] wrote {args.out}", flush=True)
        return summary
    finally:
        if created:
            dist.destroy_process_group()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.scaling_bench",
        description="Scaling efficiency: rays/s against the rank count "
                    "across mesh shapes (the sharded static step).")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    # --gaussians: the same, for torchrun's command line (its own parser
    # takes "--n" for an ambiguous prefix of its options on Python 3.12.3)
    p.add_argument("--n", "--gaussians", type=int, default=100_000)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--fragment_profile", default="lean",
                   help="lean / wide / huge, or a capacity in fragments")
    p.add_argument("--no_gauss", action="store_true",
                   help="skip gauss-sharded shapes")
    p.add_argument("--meshes", default=None,
                   help='explicit shapes "dxgxt,dxgxt,..." '
                        "(default: every factorisation)")
    p.add_argument("--out", default=None,
                   help="JSON summary path, written by the primary (default: "
                        "print only)")
    p.add_argument("--device", default="cuda",
                   help="cuda: each rank's card (default); cpu only when "
                        "asked")
    return p


def main(argv=None) -> int:
    """Runs the sweep; 1 when any mesh failed, else 0."""
    summary = run(build_parser().parse_args(argv))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
