"""Training CLI: `python -m rodygs_tpu_torch.pipelines.train`. Port of
`rodygs_tpu/pipelines/train.py`, with the same arguments.

YAML config merge and dotlist overrides, the logdir layout
`<logdir>/<group>/<name>_<seed>/train`, seeding, the config and code
snapshot, `override_config` (a CLI num_iterations propagated into the
fields that depend on it), then build and run. Runs on `--device` (`cuda`
by default; `cpu` only when asked). After the run it logs how many times
each CUDA kernel launched (all zero on the CPU).

    python -m rodygs_tpu_torch.pipelines.train -d <scene> \\
        -b configs/train/train_kubric_mrig.yaml -n <name> [--device cpu]

Multi-process (`--mesh data=N[,gauss=N][,tile=N]`, one process per mesh
position): launched by torchrun or with RODYGS_COORDINATOR /
RODYGS_NUM_PROCESSES / RODYGS_PROCESS_ID, the backend in
RODYGS_DIST_BACKEND (parallel/multihost.py). Only the primary creates the
logdir and writes args.yaml, config.yaml and the code snapshot; the others
wait for the logdir (bounded) and each logs to its own `train.p<i>.log`.

    RODYGS_DIST_BACKEND=gloo torchrun --standalone --nproc_per_node 2 \\
        -m rodygs_tpu_torch.pipelines.train -d <scene> -b <yaml> -n <name> \\
        --mesh data=2
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from pathlib import Path

import yaml

from ..utils.config import apply_dotlist, load_yaml, merge_configs


def check_argument_sanity(args) -> None:
    if args.datadir is not None and not os.path.isdir(args.datadir):
        raise SystemExit(f"datadir does not exist: {args.datadir}")
    for cfg in args.base:
        if not os.path.isfile(cfg):
            raise SystemExit(f"config does not exist: {cfg}")


def set_traindir(args, primary: bool = True, timeout_s: float = 300.0) -> Path:
    """The run's logdir. The primary creates it (a fresh run must not find
    it, unless --debug or --resume); a secondary never creates it, which
    would trip the primary's check, and waits for it, bounded."""
    logdir = Path(args.logdir) / args.group / f"{args.name}_{args.seed}" / "train"
    if primary:
        logdir.mkdir(parents=True, exist_ok=args.debug or args.resume)
        return logdir
    deadline = time.monotonic() + timeout_s
    while not logdir.is_dir():
        if time.monotonic() > deadline:
            raise RuntimeError(f"secondary process timed out waiting for the "
                               f"primary to create {logdir}")
        time.sleep(0.5)
    return logdir


def store_args_and_config(logdir: Path, args, config: dict) -> None:
    with open(logdir / "args.yaml", "w") as f:
        yaml.dump(vars(args), f)
    with open(logdir / "config.yaml", "w") as f:
        yaml.dump(config, f)


def store_code(logdir: Path) -> None:
    """Snapshot the package's source beside the run (no build outputs)."""
    src = Path(__file__).resolve().parents[1]
    dst = logdir / "code" / "rodygs_tpu_torch"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))


def override_config(config: dict, num_iterations: int | None) -> dict:
    """Propagate a CLI num_iterations into every dependent field."""
    if num_iterations is None:
        return config
    tp = config["trainer"]["params"]
    for section in ("static", "dynamic"):
        if section not in tp:
            continue
        p = tp[section]["params"]
        p["num_iterations"] = num_iterations
        p["position_lr_max_steps"] = num_iterations
        p["densify_until_iter"] = min(
            p.get("densify_until_iter", num_iterations), num_iterations)
        cam = p.get("camera_opt_config")
        if cam:
            cam["params"]["total_steps"] = num_iterations
        if "deform_lr_max_steps" in p:
            p["deform_lr_max_steps"] = num_iterations
    for key in ("static_data", "dynamic_data"):
        if key in config:
            dl = config[key]["params"].get("train_dloader_config")
            if dl and "params" in dl and dl["params"] is not None:
                dl["params"]["num_iterations"] = None  # infinite sampler
    return config


def parse_args(argv=None):
    parser = argparse.ArgumentParser("rodygs_tpu_torch training")
    parser.add_argument("-d", "--datadir", type=str, default=None,
                        help="scene directory (overrides config dirpath)")
    parser.add_argument("-b", "--base", nargs="+", required=True,
                        help="base YAML config(s), merged left to right")
    parser.add_argument("-g", "--group", type=str, default="default")
    parser.add_argument("-n", "--name", type=str, required=True)
    parser.add_argument("-l", "--logdir", type=str, default="logs")
    parser.add_argument("-s", "--seed", type=int, default=777)
    parser.add_argument("--num_iterations", type=int, default=None)
    parser.add_argument("--capacity_factor", type=float, default=4.0)
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="save a resumable snapshot every k iterations")
    parser.add_argument("--resume", action="store_true",
                        help="resume from <logdir>/resume.ckpt if present")
    parser.add_argument("--mesh", type=str, default=None,
                        help='process mesh, e.g. "data=2" or '
                             '"data=2,gauss=2,tile=2": frame data '
                             "parallelism x gaussian-store sharding x "
                             "tile-space sharding, one process per "
                             "position. Each step consumes `data` frames "
                             "(mean frame loss).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    args, unknown = parser.parse_known_args(argv)
    return args, unknown


def parse_mesh_arg(spec: str, device=None):
    """'data=2,gauss=2,tile=2' -> Mesh via parallel.mesh.make_mesh."""
    from ..parallel.mesh import make_mesh

    sizes = {"data": 1, "gauss": 1, "tile": 1}
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        k = k.strip()
        if k not in sizes or not v.strip().isdigit():
            raise SystemExit(
                f"--mesh: expected 'data=N[,gauss=N][,tile=N]', got {spec!r}")
        sizes[k] = int(v)
    return make_mesh(n_data=sizes["data"], n_tile=sizes["tile"],
                     n_gauss=sizes["gauss"], device=device)


def main(argv=None):
    from ..parallel.multihost import (is_primary, maybe_initialize_distributed,
                                      process_index)

    maybe_initialize_distributed()
    args, overrides = parse_args(argv)
    from ..utils.platform import resolve_device

    device = resolve_device(args.device)
    check_argument_sanity(args)
    mesh = None
    if args.mesh:
        # a rank's device: cuda:(LOCAL_RANK % cards), or the CPU if asked
        mesh = parse_mesh_arg(args.mesh, device if device.type == "cpu"
                              else None)
        device = mesh.device
    if args.verbose:
        os.environ["VERBOSE_RUN"] = "1"

    config = merge_configs(*[load_yaml(p) for p in args.base])
    if overrides:
        config = apply_dotlist(config, overrides)
    config = override_config(config, args.num_iterations)

    from .. import kernels
    from ..utils.logging_utils import seed_all, set_logger
    from .build import build_training_run

    seed_all(args.seed)
    primary = is_primary()
    logdir = set_traindir(args, primary=primary)
    # one log per process: appends of several processes to one file tear
    logger = set_logger(logdir, name="train" if primary
                        else f"train.p{process_index()}")
    if primary:
        store_args_and_config(logdir, args, config)
        store_code(logdir)

    if mesh is not None:
        logger.info(f"mesh {mesh.shape}: rank {mesh.rank} at {mesh.coords} "
                    f"on {device} ({mesh.backend})")
    run = build_training_run(
        config, dirpath=args.datadir, logdir=logdir, seed=args.seed,
        capacity_factor=args.capacity_factor, logger=logger, device=device,
        mesh=mesh)
    run.checkpoint_every = args.checkpoint_every
    logger.info(f"training for {run.num_iterations} iterations on {device}")
    kernels.reset_launches()
    run.train(resume=args.resume)
    logger.info(f"kernel launches {json.dumps(kernels.LAUNCHES)}")
    if mesh is not None and mesh.world_size > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return run


if __name__ == "__main__":
    main()
