"""Evaluation CLI: `python -m rodygs_tpu_torch.pipelines.eval`. Port of
`rodygs_tpu/pipelines/eval.py`, with the same arguments and `--device`
(`cuda` by default; `cpu` only when asked).

Loads the run's stored train config merged with an eval config, finds
`static_last.ckpt` / `dynamic_last.ckpt`, rebuilds the datamodules (with
the checkpoint-refined poses) and runs the evaluator; LPIPS weights come
from `--lpips_weights` or `RODYGS_LPIPS_WEIGHTS`. Prints the result, how
many times each CUDA kernel launched inside `eval()` and, with test-time
pose alignment, the pose steps' render counts (steps, retried after a
drop, still dropping).

    python -m rodygs_tpu_torch.pipelines.eval \\
        -c configs/eval/eval_wo_align.yaml -d <scene> -m <run> [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..utils.config import (apply_dotlist, instantiate_from_config, load_yaml,
                            merge_configs)


def parse_args(argv=None):
    parser = argparse.ArgumentParser("rodygs_tpu_torch evaluation")
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="eval YAML (e.g. configs/eval/eval_wo_align.yaml)")
    parser.add_argument("-t", "--task", type=str, default="eval")
    parser.add_argument("-d", "--datadir", type=str, required=True)
    parser.add_argument("-m", "--modeldir", type=str, required=True,
                        help="run logdir containing train/ with checkpoints")
    parser.add_argument("--lpips_weights", type=str, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=8,
                        help="test views rendered per chunk")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked for)")
    args, unknown = parser.parse_known_args(argv)
    return args, unknown


def main(argv=None):
    args, overrides = parse_args(argv)
    from .. import kernels
    from ..evalsuite.evaluator import RoDyGSEvaluator
    from ..utils.platform import resolve_device

    device = resolve_device(args.device)
    modeldir = Path(args.modeldir)
    train_cfg_path = modeldir / "train" / "config.yaml"
    config = merge_configs(load_yaml(str(train_cfg_path)),
                           load_yaml(args.config))
    if overrides:
        config = apply_dotlist(config, overrides)

    static_ckpt = modeldir / "train" / "static_last.ckpt"
    dynamic_ckpt = modeldir / "train" / "dynamic_last.ckpt"
    out_path = modeldir / args.task

    # rebuild the datamodules; pose readers that read the checkpoint get it
    static_dm = instantiate_from_config(
        config["static_data"], dirpath=args.datadir,
        ckpt_path=str(static_ckpt))
    dynamic_dm = None
    if not static_dm.skip_dynamic and "dynamic_data" in config:
        dynamic_dm = instantiate_from_config(
            config["dynamic_data"], dirpath=args.datadir,
            ckpt_path=str(static_ckpt))

    eval_params = dict((config.get("eval") or {}).get("params") or {})
    evaluator = RoDyGSEvaluator(
        dirpath=args.datadir,
        static_datamodule=static_dm,
        dynamic_datamodule=dynamic_dm,
        out_path=out_path,
        static_ckpt_path=static_ckpt,
        dynamic_ckpt_path=dynamic_ckpt,
        camera_lr=eval_params.get("camera_lr", config.get("camera_lr", -1)),
        num_opts=eval_params.get("num_opts", config.get("num_opts", -1)),
        lpips_weights=args.lpips_weights,
        device=device,
    )
    kernels.reset_launches()
    result = evaluator.eval(eval_batch_size=args.eval_batch_size)
    print(result)
    print(f"kernel launches {json.dumps(kernels.LAUNCHES)}")
    if evaluator.is_optimizable_cam:
        print(f"pose steps {json.dumps(evaluator.pose_render_stats)}")
    return result


if __name__ == "__main__":
    main()
