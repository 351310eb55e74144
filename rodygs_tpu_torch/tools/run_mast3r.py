"""MASt3R pose and geometry initialisation runner (needs the external
network). Port of `scripts/run_mast3r.py` (the reference's
`scripts/run_mast3r/run.py:36-358`).

    python -m rodygs_tpu_torch.tools.run_mast3r --datadir <scene>
        [--expname swin_noloop_000] [--winsize 10]
        [--optim_level refine+depth] [--device cpu]

A sliding-window (swin, winsize 10) pair graph -> MASt3R inference ->
two-stage sparse global alignment (coarse lr1 0.07 x 500, refine+depth
lr2 0.014 x 200, cosine schedule, shared intrinsics) -> per-frame dense
points, depths and confidences, exported by `mast3r_driver.run_driver`
(`op_results/pointcloud_XXXX.{ply,pkl}`, `op_results/masks/XXXX.png`,
`global_params.pkl`). The MASt3R network (naver/mast3r with dust3r, and
its checkpoint) is an external dependency, as in the reference: without
it the runner exits naming it. It runs on `--device` (default `cuda`) and
raises when there is no card; the JAX script's runner picked the CPU
silently.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..utils.platform import resolve_device
from .mast3r_driver import (TwoStageSchedule, clamp_winsize, run_driver,
                            scene_graph_string)


def main(datadir: str, expname: str, model_name: str,
         winsize: int = 10, image_size: int = 512,
         schedule: TwoStageSchedule | None = None,
         min_conf_thr: float = 1.5, device: str = "cuda"):
    try:
        from dust3r.image_pairs import make_pairs
        from dust3r.utils.image import load_images
        from mast3r.cloud_opt.sparse_ga import sparse_global_alignment
        from mast3r.cloud_opt.utils.schedules import cosine_schedule
        from mast3r.model import AsymmetricMASt3R
    except ImportError as e:
        raise SystemExit(
            "MASt3R is an external dependency (git submodule in the "
            "reference; not bundled here). Install naver/mast3r and its "
            f"checkpoint, then re-run. ({e})")

    dev = resolve_device(device)
    sched = schedule or TwoStageSchedule()
    model = AsymmetricMASt3R.from_pretrained(model_name).to(dev)
    filelist = sorted(glob.glob(os.path.join(datadir, "train", "*.png")))
    winsize = clamp_winsize(len(filelist), "swin", False, winsize)
    imgs = load_images(filelist, size=image_size)
    pairs = make_pairs(
        imgs, scene_graph=scene_graph_string("swin", winsize, False),
        prefilter=None, symmetrize=True)

    out_dir = os.path.join(datadir, "mast3r_opt", expname)
    cache_dir = os.path.join(out_dir, "cache")
    os.makedirs(cache_dir, exist_ok=True)
    # the sparse alignment runs the two-stage plan itself; it gets the
    # schedule object's stages
    stages = sched.stages()
    niter2 = stages[1][2] if len(stages) > 1 else 0
    scene = sparse_global_alignment(
        filelist, pairs, cache_dir, model,
        lr1=sched.lr1, niter1=sched.niter1, lr2=sched.lr2, niter2=niter2,
        schedule=cosine_schedule, device=str(dev),
        opt_depth="depth" in sched.optim_level, shared_intrinsics=True)

    run_driver(scene, out_dir, min_conf_thr=min_conf_thr, clean_depth=True)
    print(f"wrote {out_dir}/global_params.pkl")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.run_mast3r",
        description="MASt3R poses and geometry for a scene's train frames.")
    parser.add_argument("--datadir", required=True)
    parser.add_argument("--expname", default="swin_noloop_000")
    parser.add_argument("--model_name",
                        default="naver/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric")
    parser.add_argument("--winsize", type=int, default=10)
    parser.add_argument("--optim_level", default="refine+depth",
                        choices=["coarse", "refine", "refine+depth"])
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when "
                             "asked)")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    main(args.datadir, args.expname, args.model_name, args.winsize,
         schedule=TwoStageSchedule(optim_level=args.optim_level),
         device=args.device)
