"""Multi-process smoke test: the dry run over processes that find each
other through the explicit RODYGS_* contract. Port of
`scripts/multihost_smoke.py`.

    python -m rodygs_tpu_torch.tools.multihost_smoke [--ranks 2]
        [--backend nccl|gloo] [--device cpu]

The launcher starts `--ranks` OS processes, each with RODYGS_COORDINATOR
(127.0.0.1 and a free port), RODYGS_NUM_PROCESSES, RODYGS_PROCESS_ID and
RODYGS_DIST_BACKEND set, so each bootstraps torch.distributed through
`parallel.multihost.maybe_initialize_distributed` (the code path a
multi-host launch takes; not torchrun). Each runs the port's dry run
(`parallel.dryrun.dryrun_rank`, the counterpart of
`__graft_entry__.dryrun_multichip`: the joint trainer's static step,
sharded densification of both stores, the dynamic step, a forced
escalation, the SH ramp and a resume round trip through a directory the
processes share) on a mesh whose data axis has 2 rows, so every `pmean` on
that axis crosses processes (`smoke_mesh`). `--backend nccl` puts each
process on its own card; `--backend gloo --device cpu` runs on the CPU.

Success, as in the JAX script: every worker prints the same finite losses
as the dry run spawned from one process (`parallel.dryrun.run_world`) on
the same mesh; besides, the shared directory holds the one resume file the
primary wrote. Exits non-zero otherwise, or when a worker fails or
outlives its deadline (600 s a world).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.dryrun import default_mesh, dryrun_rank, run_world
from ..parallel.multihost import (dist_backend, maybe_initialize_distributed,
                                  process_count, process_index)
from ..utils.platform import device_label, resolve_device

REPO = Path(__file__).resolve().parents[2]
MODULE = "rodygs_tpu_torch.tools.multihost_smoke"
RESULT = "[worker result] "


def smoke_mesh(n: int) -> dict:
    """Two data rows (when n is even), the rest folded into the gauss and
    tile axes as the dry run folds a rank count (`default_mesh`)."""
    n_data = 2 if n % 2 == 0 else 1
    shape = default_mesh(n // n_data)
    return {"data": n_data * shape["data"], "gauss": shape["gauss"],
            "tile": shape["tile"]}


def worker() -> None:
    """One process of the launch (the RODYGS_* variables set): the dry run
    on its mesh position; prints its summary."""
    if not maybe_initialize_distributed():
        raise RuntimeError("the RODYGS_* bootstrap did not start a world")
    n = process_count()
    device = os.environ.get("SMOKE_DEVICE") or None
    try:
        summary = dryrun_rank(process_index(), smoke_mesh(n), device,
                              os.environ["SMOKE_SHARED"])
    finally:
        dist.destroy_process_group()
    print(RESULT + json.dumps(summary), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(ranks: int, backend: str, device: str | None = None,
           timeout_s: float = 600.0) -> dict:
    """Run the workers and the one-process dry run; returns {"ok",
    "workers": summaries (None for a failed worker), "reference": the dry
    run's summaries, "outputs": the workers' text, "shared": the shared
    directory's files}."""
    shape = smoke_mesh(ranks)
    root = tempfile.mkdtemp(prefix="rodygs_multihost_")
    shared = os.path.join(root, "shared")
    os.makedirs(shared)
    port = _free_port()
    procs = []
    try:
        for pid in range(ranks):
            env = dict(os.environ, RODYGS_COORDINATOR=f"127.0.0.1:{port}",
                       RODYGS_NUM_PROCESSES=str(ranks),
                       RODYGS_PROCESS_ID=str(pid), RODYGS_DIST_BACKEND=backend,
                       SMOKE_SHARED=shared, SMOKE_DEVICE=device or "",
                       OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, "--worker"],
                cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outputs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    workers = []
    for p, text in zip(procs, outputs):
        lines = [ln for ln in text.splitlines() if ln.startswith(RESULT)]
        workers.append(json.loads(lines[-1][len(RESULT):])
                       if p.returncode == 0 and lines else None)
    files = sorted(os.listdir(shared))
    ref_dir = os.path.join(root, "reference")
    os.makedirs(ref_dir)
    try:
        reference = run_world(dryrun_rank, ranks, (shape, device, ref_dir),
                              backend=backend, timeout_s=timeout_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # as the workers print them (tuples become lists)
    reference = json.loads(json.dumps(reference))
    losses = reference[0]["losses"]
    ok = (all(w is not None and w["losses"] == losses for w in workers)
          and bool(np.isfinite(losses).all())
          and files == ["dryrun_resume.ckpt"])
    return {"ok": ok, "shape": shape, "workers": workers,
            "reference": reference, "outputs": outputs, "shared": files}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.multihost_smoke",
        description="The dry run over processes joined by the RODYGS_* "
                    "contract, against the one-process dry run.")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--backend", default=None,
                   help="nccl (one card per process) or gloo (default: "
                        "$RODYGS_DIST_BACKEND)")
    p.add_argument("--device", default=None,
                   help="cpu, or the processes' CUDA cards (default)")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker()
        return 0
    backend = dist_backend(args.backend)
    dev = resolve_device(args.device)
    card = dev if dev.type == "cpu" else torch.device("cuda", 0)
    print(f"[multihost] {device_label(card)}; {args.ranks} processes over "
          f"{backend}, mesh {smoke_mesh(args.ranks)}", flush=True)
    res = launch(args.ranks, backend, args.device)
    for pid, (w, text) in enumerate(zip(res["workers"], res["outputs"])):
        tail = "\n".join(text.strip().splitlines()[-4:])
        state = "OK" if w is not None else "FAILED"
        print(f"--- worker {pid} {state} ---\n{tail}", flush=True)
    ref = res["reference"][0]["losses"]
    print(f"[multihost] one-process dry run losses {ref}", flush=True)
    for pid, w in enumerate(res["workers"]):
        if w is not None:
            print(f"[multihost] worker {pid} {w['coords']}: losses "
                  f"{w['losses']}, equal: {w['losses'] == ref}", flush=True)
    print(f"[multihost] shared directory: {res['shared']}", flush=True)
    print("MULTIHOST_SMOKE " + ("PASS" if res["ok"] else "FAIL"), flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
