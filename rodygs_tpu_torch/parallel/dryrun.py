"""Spawned worlds, and a dry run of the whole training stack over a mesh.

`run_world(target, n, args)` spawns n processes (`spawn`, never `fork`),
joins them into one torch.distributed world (a FileStore init) and calls
`target(rank, *args)` in each; it returns the ranks' results, in rank
order. Every world has a deadline of its own: the process group's
collectives time out, and the parent kills every rank and raises when a
rank fails or the deadline passes, so a rank that skips a collective fails
the caller instead of hanging it. Each rank runs torch on one CPU thread
(the ranks share the host's cores). `target` and its module must be
importable in a fresh process (the ranks import nothing of the caller's
but that module).

The dry run is the port's twin of the JAX package's `dryrun_multichip`
(`__graft_entry__.py`) and `scripts/multihost_smoke.py`: each rank builds
the same seeded scene and runs the joint trainer over the mesh for six
iterations: sharded densification of both stores every second iteration,
a forced fragment-profile escalation (a tiny initial capacity), the SH
ramp, then a resume save -> perturb -> load -> step round trip through a
directory the ranks share.

    python -m rodygs_tpu_torch.parallel.dryrun --ranks 4 --backend gloo \\
        [--device cpu]

The mesh folds the rank count into all three axes (`default_mesh`).
Without `--device cpu` the ranks share the CUDA cards (rank r on card
r mod count); ranks that share a card need `--backend gloo`.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import dist_backend


def _rank_main(rank, world, init_file, backend, timeout_s, target, args,
               results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, target(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target, world_size: int, args=(), *, backend: str,
              timeout_s: float = 300.0) -> list:
    """Run `target(rank, *args)` on every rank of a new world of
    `world_size` processes over `backend`; the results in rank order.
    Raises when a rank fails (with its traceback) or when the world
    outlives `timeout_s`."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rodygs_world_")
    init_file = os.path.join(tmp, "init")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world_size, init_file, backend, timeout_s, target, args, results))
        for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {world_size} ranks outlived {timeout_s:.0f} s; "
                    f"ranks {sorted(set(range(world_size)) - set(out))} "
                    "never finished")
            try:
                rank, ok, value = results.get(timeout=min(1.0, left))
            except queue.Empty:
                lost = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)}
                if lost:
                    raise RuntimeError(f"ranks died without a result (rank: "
                                       f"exit code) {lost}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]


def default_mesh(n: int) -> dict:
    """The dry run's mesh: the rank count folded into all three axes where
    it divides (as `dryrun_multichip` folds its device count)."""
    n_gauss = 2 if n % 2 == 0 and n > 1 else 1
    n_tile = 2 if n % (2 * n_gauss) == 0 else 1
    return {"data": n // (n_gauss * n_tile), "gauss": n_gauss,
            "tile": n_tile}


def dryrun_rank(rank: int, shape: dict, device: str | None, shared: str,
                iterations: int = 6) -> dict:
    """One rank of the dry run; returns its summary (asserting as it
    goes)."""
    from .. import kernels
    from ..models import gaussians as G
    from ..train.losses import LossTerm, MultiLoss
    from ..train.optim import CameraPoses
    from ..train.trainer_dynamic import DynTrainer, DynTrainerConfig
    from ..train.trainer_joint import RoDyGSTrainer
    from ..train.trainer_static import (FrameBatch, StaticTrainerConfig,
                                        ThreeDGSTrainer)
    from .collectives import psum
    from .mesh import make_mesh
    from .sharded import stack_batches

    mesh = make_mesh(n_data=shape["data"], n_tile=shape["tile"],
                     n_gauss=shape["gauss"], device=device)
    dev = mesh.device
    W, H = 64, 48
    rng = np.random.default_rng(0)
    n = 120
    pts = rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5],
                      size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    store = G.from_point_cloud(pts, cols, sh_degree=1, capacity=256,
                               device=dev)
    f = max(mesh.shape["data"], 2)
    poses = CameraPoses(
        q_c2w=torch.tensor([[1.0, 0, 0, 0]] * f, device=dev),
        t_c2w=torch.tensor(rng.uniform(-0.1, 0.1, size=(f, 3)),
                           dtype=torch.float32, device=dev))
    loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                      LossTerm("d_ssim", 0.2, "SSIMLoss")])
    # both models densify every second iteration from iteration 1
    sched = dict(image_width=W, image_height=H, sh_degree=1,
                 densification_interval=2, densify_from_iter=1,
                 densify_until_iter=100, densify_grad_threshold=1e-8)
    st = ThreeDGSTrainer(StaticTrainerConfig(
        camera_rotation_lr=1e-5, camera_translation_lr=1e-6, **sched),
        loss, store, poses, spatial_lr_scale=3.0, seed=0, mesh=mesh)
    dyn_store = G.from_point_cloud(pts[:60], cols[:60], sh_degree=1,
                                   capacity=128,
                                   times=np.zeros(60, np.float32), device=dev)
    dyn_loss = MultiLoss([LossTerm("l1", 0.8, "L1Loss"),
                          LossTerm("motion_l1", 0.01, "MotionL1Loss")])
    dt = DynTrainer(DynTrainerConfig(
        deform_netwidth=32, deform_t_emb_multires=6, num_basis=4, **sched),
        dyn_loss, dyn_store, 3.0, seed=2, mesh=mesh)
    joint = RoDyGSTrainer(st, dt, sh_up_start_iteration=2, sh_up_period=2,
                          mesh=mesh)
    # far below demand: the first poll (iteration 5) must escalate
    st.fragment_profile = profile0 = 128
    frames = []
    for i in range(mesh.shape["data"]):
        gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
        frames.append(FrameBatch(
            gt_image=torch.tensor(gt, device=dev), gt_depth=None,
            motion_mask=None, frame_idx=i % f,
            time=torch.tensor(0.0, device=dev),
            fovx=torch.tensor(0.9, device=dev),
            fovy=torch.tensor(0.7, device=dev)))
    batch = stack_batches(frames)

    xyz0 = st.state.store.params.xyz.clone()
    events = {"densify_static": 0, "densify_dynamic": 0}
    kernels.reset_launches()
    losses = []
    for it in range(1, iterations + 1):
        m = joint.train_iteration(batch, batch, it)
        losses.append((float(m["static"]["loss"]), float(m["dynamic"]["loss"])))
        if not all(np.isfinite(losses[-1])):
            raise AssertionError(f"non-finite loss at {it}: {losses[-1]}")
        events["densify_static"] += int("static_densify" in m)
        events["densify_dynamic"] += int("dynamic_densify" in m)
    launches = dict(kernels.LAUNCHES)
    if min(events.values()) < 2:
        raise AssertionError(f"too few densifications: {events}")
    if st.fragment_profile == profile0:
        raise AssertionError("the forced overflow never escalated")
    if st.active_sh_degree != 1:
        raise AssertionError(f"SH degree {st.active_sh_degree} after the ramp")
    moved = float((st.state.store.params.xyz - xyz0).abs().max())
    if not moved > 0:
        raise AssertionError("the static store did not move")

    ckpt = os.path.join(shared, "dryrun_resume.ckpt")
    joint.save_resume(ckpt, iterations)
    xyz_saved = st.state.store.params.xyz.clone()
    st.state = st.state._replace(store=st.state.store._replace(
        params=st.state.store.params._replace(xyz=torch.zeros_like(xyz_saved))))
    nxt = joint.load_resume(ckpt)
    if nxt != iterations + 1 or not torch.equal(st.state.store.params.xyz,
                                               xyz_saved):
        raise AssertionError("the resume round trip lost the state")
    m = joint.train_iteration(batch, batch, nxt)
    if not np.isfinite(float(m["static"]["loss"])):
        raise AssertionError("non-finite loss after the resume")
    alive = psum(torch.stack([G.num_alive(st.state.store)]),
                 mesh.axis("gauss"))
    return {"rank": rank, "coords": mesh.coords, "shape": mesh.shape,
            "losses": losses, "events": events,
            "profile": [profile0, st.fragment_profile],
            "sh": st.active_sh_degree, "moved": moved,
            "alive": [int(alive), int(G.num_alive(dt.state.store))],
            "launches": launches}


def dryrun(ranks: int, backend: str, device: str | None = None,
           timeout_s: float = 600.0) -> list:
    """Run the dry run on a spawned world of `ranks` ranks over
    `default_mesh(ranks)`; the ranks' summaries."""
    shape = default_mesh(ranks)
    shared = tempfile.mkdtemp(prefix="rodygs_dryrun_")
    try:
        return run_world(dryrun_rank, ranks, (shape, device, shared),
                         backend=backend, timeout_s=timeout_s)
    finally:
        shutil.rmtree(shared, ignore_errors=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("rodygs_tpu_torch multi-device dry run")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--backend", default=None,
                   help="gloo or nccl (default: $RODYGS_DIST_BACKEND)")
    p.add_argument("--device", default=None,
                   help="cpu, or the ranks' CUDA cards (default)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    out = dryrun(args.ranks, dist_backend(args.backend), args.device)
    for summary in out:
        print(json.dumps(summary))
    print(f"dryrun: {args.ranks} ranks, mesh {out[0]['shape']}, "
          f"{time.perf_counter() - t0:.1f} s: PASS")


if __name__ == "__main__":
    main()
