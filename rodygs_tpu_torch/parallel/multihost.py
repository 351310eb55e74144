"""Multi-process bootstrap and the shared-filesystem discipline. Port of
`rodygs_tpu/parallel/multihost.py` on `torch.distributed`.

Every function is a no-op (or trivially true) in a single process, so
local runs are unaffected. The train CLI calls
`maybe_initialize_distributed()` first. Recognised launches, in order:
  * explicit: RODYGS_COORDINATOR (host:port) + RODYGS_NUM_PROCESSES +
    RODYGS_PROCESS_ID, initialised over `tcp://<coordinator>`;
  * torchrun: RANK / WORLD_SIZE (> 1) / MASTER_ADDR / MASTER_PORT, over
    `env://` (the counterpart of the TPU runtime's own discovery);
  * neither: return False without touching torch.distributed.
The backend is stated, never guessed: RODYGS_DIST_BACKEND ("nccl": one
card per rank; "gloo": the CPU, or ranks that share a card).

Shared logdirs: only the primary writes checkpoints, resume files, code
snapshots and evaluation outputs; every process then meets at `barrier`
before any may read them; `wait_for_path` bounds the wait for a file to
become visible; `broadcast_flag` makes every process take the primary's
decision where a filesystem check could split the collective program.
"""

from __future__ import annotations

import datetime
import os
import time

import torch.distributed as dist

from .mesh import BACKEND_ENV

# how long a collective may wait before the process group fails it
DEFAULT_TIMEOUT_S = 600.0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns shared-filesystem writes."""
    return process_index() == 0


def barrier(tag: str = "rodygs_ckpt") -> None:
    """Cross-process barrier; a no-op in a single process. `tag` names the
    meeting point in the JAX package and is not used by torch."""
    del tag
    if process_count() > 1:
        dist.barrier()


def wait_for_path(path, timeout_s: float = 120.0, poll_s: float = 0.25):
    """Bounded wait for a shared-filesystem path to become visible
    (multi-process only: a single process lets its open() raise)."""
    if process_count() <= 1:
        return
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            raise FileNotFoundError(
                f"{path} not visible on process {process_index()} after "
                f"{timeout_s:.0f}s")
        time.sleep(poll_s)


def broadcast_flag(value: bool) -> bool:
    """Every process adopts the primary's boolean."""
    if process_count() <= 1:
        return bool(value)
    box = [bool(value)]
    dist.broadcast_object_list(box, src=0)
    return bool(box[0])


def dist_backend(backend: str | None = None) -> str:
    """The backend the caller stated: `backend`, else RODYGS_DIST_BACKEND."""
    backend = backend or os.environ.get(BACKEND_ENV)
    if backend not in ("nccl", "gloo"):
        raise ValueError(
            f"a multi-process run needs its backend stated: pass backend= or "
            f"set {BACKEND_ENV} to 'nccl' (one card per rank) or 'gloo' (the "
            f"CPU, or ranks sharing a card); got {backend!r}")
    return backend


def maybe_initialize_distributed(logger=None) -> bool:
    """Initialise torch.distributed when launched as several processes
    (over the backend RODYGS_DIST_BACKEND states, collectives timing out
    after DEFAULT_TIMEOUT_S); returns True when a multi-process world is
    (now) initialised."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coord = os.environ.get("RODYGS_COORDINATOR")
    if coord:
        num = int(os.environ["RODYGS_NUM_PROCESSES"])
        pid = int(os.environ["RODYGS_PROCESS_ID"])
        init = dict(init_method=f"tcp://{coord}", world_size=num, rank=pid)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1 and "RANK" in os.environ:
        init = dict(init_method="env://")
    else:
        return False
    dist.init_process_group(
        dist_backend(), timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        **init)
    if logger is not None:
        logger.info(f"distributed: process {dist.get_rank()}/"
                    f"{dist.get_world_size()} ({dist.get_backend()})")
    return True
