"""The work the dynamic step replicates on every rank of a gauss-sharded
mesh, timed on one card. Port of `scripts/measure_dyn_replication.py`.

    python -m rodygs_tpu_torch.tools.measure_dyn_replication
        [--capacity 262144] [--joint_ms MS] [--device cpu]

Under a gauss-sharded mesh the render, the compositing and the
densification of the dynamic step are split over the ranks; two parts are
not: the motion-MLP deformation (forward + backward over the full
capacity, here with a surrogate cotangent of 1e-3 so that the whole
backward runs) and the dynamic store's Adam update. This tool times both at
the flagship's dynamic configuration (1920x1080, width 128, 26 time
frequencies, 16 bases, inverse motion; a store of `--capacity` slots, 3/4
of them alive, from the JAX script's numpy draws).

Each part is read two ways on the card. Its device time (`deform_ms`,
`adam_ms`) is the kernel time of 30 warm calls under `torch.profiler`,
per call: the work a rank's card repeats. Its stream time
(`*_stream_ms`) is CUDA events around 30 warm calls that the host
launches back to back, per call, as the median of 3 windows with their
[min, max]: it includes the launch gaps, so where it exceeds the device
time the loop is bound by the host's launches, not by the card. On the
CPU only the host clock's stream time is read. With `--joint_ms`, a joint
iteration's ms measured on the same card, the device time of both parts
is also given as its share of that iteration; without it, only the times
are reported.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import gaussians as G
from ..train.losses import LossTerm, MultiLoss
from ..train.optim import adam_init, adam_update, tree_leaves, tree_map
from ..train.trainer_dynamic import DynTrainer, DynTrainerConfig
from ..utils.platform import device_label, resolve_device

REPS, WINDOWS = 30, 3  # warm calls a reading, stream-time windows


def build(capacity: int, device=None) -> DynTrainer:
    """The dynamic trainer of the JAX script: a store of `capacity` slots
    holding 3/4 * capacity points with birth times i/11, SH 3."""
    dev = resolve_device(device)
    n = capacity * 3 // 4
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    times = (rng.integers(0, 12, size=n) / 11).astype(np.float32)
    store = G.from_point_cloud(pts, cols, sh_degree=3, capacity=capacity,
                               times=times, device=dev)
    cfg = DynTrainerConfig(
        image_width=1920, image_height=1080, sh_degree=3,
        deform_netwidth=128, deform_t_emb_multires=26, num_basis=16,
        inverse_motion=True)
    loss = MultiLoss([LossTerm("l1", 1.0, "L1Loss")])
    return DynTrainer(cfg, loss, store, 5.0, seed=0, device=dev)


def deform_value_and_grad(dt: DynTrainer, params, t):
    """The surrogate loss sum(translation * 1e-3) + sum(rotation * 1e-3) of
    the deformation at time `t` over the whole store, and its gradients
    (the params' tree)."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(True), params)
    transl, rot_delta = dt.deformation(leaves, t, dt.state.store.time_ind)
    loss = torch.sum(transl * 1e-3) + torch.sum(rot_delta * 1e-3)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                     allow_unused=True,
                                     materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def adam_step(dt: DynTrainer, grads, opt, params, iteration=1000.0):
    """The dynamic store's Adam update at `iteration`'s learning rates."""
    return adam_update(grads, opt, params, dt.lr_tree(iteration))


def stream_ms(fn, device: torch.device):
    """(median, min, max) over WINDOWS of the mean ms of REPS calls of
    `fn` after one call: CUDA events on the card (launch gaps included),
    the host clock elsewhere."""
    fn()
    wins = []
    for _ in range(WINDOWS):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            wins.append(start.elapsed_time(end) / REPS)
        else:
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            wins.append((time.perf_counter() - t0) / REPS * 1e3)
    return float(np.median(wins)), float(min(wins)), float(max(wins))


def device_ms(fn, device: torch.device):
    """Kernel time per call of `fn` on the card: the device events' self
    time over REPS warm calls under torch.profiler; None off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize(device)
    events = prof.key_averages()
    # a record_function range (motion_mlp) shows on the device too, over
    # the kernels it holds: keep the device events no host event names
    ranges = {e.key for e in events
              if e.device_type == torch.autograd.DeviceType.CPU}
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.key not in ranges)
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / 1e3 / REPS


def main(args) -> dict:
    """Returns {capacity, deform_ms, adam_ms, total_ms (device time, None
    off the card), deform_stream_ms, adam_stream_ms ([median, min, max]),
    share (or None), device}."""
    dev = resolve_device(args.device)
    label = device_label(dev)
    print(f"[dyn-replication] {label}", flush=True)
    dt = build(args.capacity, dev)
    params = dt.params()
    t_val = torch.tensor(0.37, device=dev)
    _, g = deform_value_and_grad(dt, params, t_val)
    opt0 = adam_init(params)
    parts = {"deform": lambda: deform_value_and_grad(dt, params, t_val),
             "adam": lambda: adam_step(dt, g, opt0, params)}
    res = {"capacity": args.capacity}
    for name, fn in parts.items():
        res[f"{name}_stream_ms"] = list(stream_ms(fn, dev))
        res[f"{name}_ms"] = device_ms(fn, dev)
    on_card = res["deform_ms"] is not None
    total = res["deform_ms"] + res["adam_ms"] if on_card else None
    share = total / args.joint_ms if on_card and args.joint_ms else None
    streams = ", ".join(
        f"{name} {m:.4f} [{lo:.4f}, {hi:.4f}]"
        for name in parts for m, lo, hi in [res[f"{name}_stream_ms"]])
    line = f"[dyn-replication] capacity={args.capacity}: "
    if on_card:
        line += (f"device time: deformation fwd+bwd {res['deform_ms']:.4f} "
                 f"ms, dyn-store adam {res['adam_ms']:.4f} ms, total "
                 f"replicated {total:.4f} ms")
        if share is not None:
            line += (f" = {share * 100:.2f}% of a {args.joint_ms:.2f} ms "
                     f"joint iteration (per rank)")
        line += "; "
    line += f"stream time (median [min, max]) ms: {streams}"
    print(line, flush=True)
    return {**res, "total_ms": total, "share": share, "device": label}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.measure_dyn_replication",
        description="Time the deformation and the dynamic Adam update that "
                    "every rank of a gauss-sharded mesh replicates.")
    p.add_argument("--capacity", type=int, default=262144)
    p.add_argument("--joint_ms", type=float, default=None,
                   help="a joint iteration's ms on the same card; the "
                        "replicated share is reported against it")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
