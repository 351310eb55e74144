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
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path

import yaml

from ..utils.config import apply_dotlist, load_yaml, merge_configs


def check_argument_sanity(args) -> None:
    if args.datadir is not None and not os.path.isdir(args.datadir):
        raise SystemExit(f"datadir does not exist: {args.datadir}")
    for cfg in args.base:
        if not os.path.isfile(cfg):
            raise SystemExit(f"config does not exist: {cfg}")


def set_traindir(args) -> Path:
    logdir = Path(args.logdir) / args.group / f"{args.name}_{args.seed}" / "train"
    logdir.mkdir(parents=True, exist_ok=args.debug or args.resume)
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
                        help="device mesh (multi-device training is not "
                             "ported yet; the argument is refused)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    args, unknown = parser.parse_known_args(argv)
    return args, unknown


def main(argv=None):
    args, overrides = parse_args(argv)
    if args.mesh is not None:
        raise SystemExit(
            "--mesh: multi-device training is not ported to rodygs_tpu_torch "
            "yet (ROADMAP queue item 4, multi-device); run without --mesh")
    from ..utils.platform import resolve_device

    device = resolve_device(args.device)
    check_argument_sanity(args)
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
    logdir = set_traindir(args)
    logger = set_logger(logdir, name="train")
    store_args_and_config(logdir, args, config)
    store_code(logdir)

    run = build_training_run(
        config, dirpath=args.datadir, logdir=logdir, seed=args.seed,
        capacity_factor=args.capacity_factor, logger=logger, device=device)
    run.checkpoint_every = args.checkpoint_every
    logger.info(f"training for {run.num_iterations} iterations on {device}")
    kernels.reset_launches()
    run.train(resume=args.resume)
    logger.info(f"kernel launches {json.dumps(kernels.LAUNCHES)}")
    return run


if __name__ == "__main__":
    main()
