"""The MASt3R alignment driver's logic, importable without the external
network. Port of `scripts/mast3r_driver.py` (the reference's
`scripts/run_mast3r/run.py:36-358`): the pair graph, the window-size clamp,
the two-stage (coarse -> refine+depth) cosine schedule and the per-frame
geometry collection and export that makes the training-input files. Only
the network's inference and sparse global alignment stay behind
`run_mast3r.py`'s gated import.

Output contract (read by `rodygs_tpu_torch/data/readers.py` and
`mast3r_unproject.py`):
  <outdir>/op_results/pointcloud_XXXX.ply   confident points, coloured
  <outdir>/op_results/pointcloud_XXXX.pkl   per-frame cam_params dict
  <outdir>/op_results/masks/XXXX.png        confidence mask (0 where kept)
  <outdir>/global_params.pkl                {focals, cam2worlds,
                                             pointcloud_paths, max_depths,
                                             depths, masks}
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np
from PIL import Image

from ..utils.ply import write_ply

# ---------------------------------------------------------------------------
# Pair graph (the reference delegates to dust3r's make_pairs; semantics
# re-derived here so the graph is constructible and testable in-repo)
# ---------------------------------------------------------------------------


def clamp_winsize(num_files: int, scenegraph_type: str = "swin",
                  win_cyclic: bool = False, winsize: int = 10) -> int:
    """Clamp the requested window size to the feasible range for the given
    scene-graph type (`run.py:64-80` behavior): a cyclic sliding window can
    reach at most ceil((F-1)/2) before pairs duplicate; noncyclic at most
    F-1; log-windows shrink both by log2."""
    max_winsize, min_winsize = 1, 1
    if scenegraph_type == "swin":
        if win_cyclic:
            max_winsize = max(1, math.ceil((num_files - 1) / 2))
        else:
            max_winsize = num_files - 1
    elif scenegraph_type == "logwin":
        if win_cyclic:
            half = math.ceil((num_files - 1) / 2)
            max_winsize = max(1, math.ceil(math.log(half, 2)))
        else:
            max_winsize = max(1, math.ceil(math.log(num_files, 2)))
    return min(max_winsize, max(min_winsize, winsize))


def build_pair_graph(num_files: int, scenegraph_type: str = "swin",
                     winsize: int = 10, win_cyclic: bool = False,
                     refid: int = 0,
                     symmetrize: bool = True) -> list[tuple[int, int]]:
    """Frame-index pair list for the matcher.

    swin: each frame pairs with the next `winsize` frames (wrapping when
    cyclic) — the video-natural graph the reference trains on
    (scene_graph="swin-10-noncyclic", `run.py:265,327`). logwin: power-of-
    two offsets 1,2,4,... for long-range loop closure. oneref: a star
    around `refid`. Symmetrize appends the reversed pairs (matching is
    direction-dependent in MASt3R).
    """
    winsize = clamp_winsize(num_files, scenegraph_type, win_cyclic, winsize)
    pairs: list[tuple[int, int]] = []
    if scenegraph_type == "swin":
        offsets = range(1, winsize + 1)
    elif scenegraph_type == "logwin":
        offsets = [2 ** k for k in range(winsize)]
    elif scenegraph_type == "oneref":
        offsets = None
    else:
        raise ValueError(f"unknown scenegraph_type {scenegraph_type!r}")

    if offsets is None:  # star graph
        pairs = [(refid, j) for j in range(num_files) if j != refid]
    else:
        for i in range(num_files):
            for off in offsets:
                j = i + off
                if win_cyclic:
                    j = j % num_files
                    if j == i:
                        continue
                elif j >= num_files:
                    continue
                a, b = (i, j) if i < j else (j, i)
                if (a, b) not in pairs:
                    pairs.append((a, b))
    if symmetrize:
        pairs = pairs + [(b, a) for (a, b) in pairs]
    return pairs


# ---------------------------------------------------------------------------
# Two-stage schedule orchestration
# ---------------------------------------------------------------------------


def cosine_lr(t: float, lr_start: float, lr_end: float = 0.0) -> float:
    """Cosine LR interpolation at progress t in [0,1] (mast3r's
    `cosine_schedule` shape: start at lr_start, anneal to lr_end)."""
    t = min(max(float(t), 0.0), 1.0)
    return lr_end + (lr_start - lr_end) * (1.0 + math.cos(t * math.pi)) / 2.0


@dataclass
class TwoStageSchedule:
    """The reference's sparse-GA optimization plan (`run.py:36-61,316-339`):
    stage 1 "coarse" — pose-only at lr1 for niter1 steps; stage 2
    "refine" — poses + (optionally) per-frame depth at lr2 for niter2
    steps. `optim_level="coarse"` zeroes stage 2 (`run.py:266-267`);
    "refine+depth" (the shipped default) turns depth optimization on."""

    lr1: float = 0.07
    niter1: int = 500
    lr2: float = 0.014
    niter2: int = 200
    optim_level: str = "refine+depth"

    def stages(self):
        niter2 = 0 if self.optim_level == "coarse" else self.niter2
        out = [("coarse", self.lr1, self.niter1, False)]
        if niter2 > 0:
            out.append(("refine", self.lr2, niter2,
                        "depth" in self.optim_level))
        return out


def run_two_stage_alignment(backend, pairs, schedule: TwoStageSchedule,
                            log=print):
    """Drive the backend through the coarse->refine plan with per-step
    cosine LRs. The backend owns the actual parameters + residuals (the
    real one wraps MASt3R's sparse GA; tests use a mock that records the
    trajectory): `backend.prepare(pairs)` once, then
    `backend.step(stage, lr, opt_depth)` per iteration, then
    `backend.finalize()` returns the scene object."""
    backend.prepare(pairs)
    for stage, lr0, niter, opt_depth in schedule.stages():
        log(f"[mast3r-driver] stage {stage}: {niter} steps @ lr {lr0} "
            f"(opt_depth={opt_depth})")
        for it in range(niter):
            lr = cosine_lr(it / max(niter - 1, 1), lr0)
            backend.step(stage, lr, opt_depth)
    return backend.finalize()


# ---------------------------------------------------------------------------
# Geometry collection + export (the training-input file contract)
# ---------------------------------------------------------------------------


def collect_geometry(scene, min_conf_thr: float = 1.5,
                     clean_depth: bool = True):
    """Pull optimized values off a scene object (`run.py:84-106`): images,
    dense 3D points, confidence masks, focals, cam2worlds, and depthmaps
    normalized by the GLOBAL max depth (one scalar across all frames —
    consumers rescale with the stored max, `mast3r_unproject.py`).

    `scene` needs: .imgs (list of [H,W,3] float arrays),
    .get_focals() -> [F], .get_im_poses() -> [F,4,4],
    .get_dense_pts3d(clean_depth=) -> (pts3d, depths, confs) lists.
    Torch tensors are accepted (detached to numpy)."""

    def _np(x):
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    imgs = [_np(im) for im in scene.imgs]
    focals = _np(scene.get_focals()).reshape(-1)
    cams2world = _np(scene.get_im_poses())
    pts3d, depths, confs = scene.get_dense_pts3d(clean_depth=clean_depth)
    pts3d = [_np(p).reshape(-1, 3) for p in pts3d]
    depths = [_np(d) for d in depths]
    masks = [_np(c) > min_conf_thr for c in confs]
    depths_max = float(max(d.max() for d in depths))
    depths = [d / depths_max for d in depths]
    return imgs, pts3d, masks, focals, cams2world, depths, depths_max


def export_geometry(outdir: str | Path, imgs, pts3d, masks, focals,
                    cams2world, depths, depths_max,
                    filter_pct: bool = True) -> dict:
    """Write the per-frame artifacts + build global_params
    (`run.py:120-216` contract): confident colored points to
    op_results/pointcloud_XXXX.ply, per-frame cam_params pickles, inverted
    confidence masks as PNGs, and the global dict (pickled by the caller
    to <outdir>/global_params.pkl)."""
    outdir = Path(outdir)
    op_dir = outdir / "op_results"
    mask_dir = op_dir / "masks"
    mask_dir.mkdir(parents=True, exist_ok=True)

    n = len(pts3d)
    if not len(masks) == len(depths) == n <= len(imgs) <= len(cams2world):
        raise ValueError(
            f"export_geometry: {len(pts3d)} point sets, {len(masks)} masks, "
            f"{len(depths)} depths, {len(imgs)} images, {len(cams2world)} "
            "poses (need equal points, masks and depths, no more than the "
            "images and the poses)")
    global_dict = {"focals": [], "cam2worlds": [], "pointcloud_paths": [],
                   "max_depths": [], "depths": [], "masks": []}
    # shared intrinsics: one focal may cover all frames
    focals = np.broadcast_to(np.asarray(focals).reshape(-1), (n,)) \
        if np.asarray(focals).size in (1, n) else np.asarray(focals)

    for i in range(n):
        img = np.asarray(imgs[i], np.float32)
        depth = np.asarray(depths[i], np.float32).reshape(img.shape[:2])
        m = np.asarray(masks[i]).reshape(-1)
        pts = np.asarray(pts3d[i], np.float32).reshape(-1, 3)
        cols = img.reshape(-1, 3)
        if filter_pct:
            keep = m & np.isfinite(pts.sum(axis=1))
            pts, cols = pts[keep], cols[keep]
        ply_path = op_dir / f"pointcloud_{i:04d}.ply"
        write_ply(ply_path, pts, colors=cols)

        cam_params = {
            "focal": float(focals[i]),
            "cam2world": np.asarray(cams2world[i], np.float32),
            "c2w_original": np.asarray(cams2world[i], np.float32),
            "depth": depth,
            "depth_max": depths_max,
            "base_extrinsic": np.asarray(cams2world[0], np.float32),
        }
        with open(op_dir / f"pointcloud_{i:04d}.pkl", "wb") as f:
            pickle.dump(cam_params, f)

        # inverted mask png: 255 where the point was NOT confident
        png = np.where(m.reshape(depth.shape), 0, 255).astype(np.uint8)
        Image.fromarray(png, mode="L").save(mask_dir / f"{i:04d}.png")

        global_dict["focals"].append(float(focals[i]))
        global_dict["cam2worlds"].append(np.asarray(cams2world[i],
                                                    np.float32))
        global_dict["pointcloud_paths"].append(str(ply_path))
        global_dict["max_depths"].append(depths_max)
        global_dict["depths"].append(depth)
        global_dict["masks"].append(np.asarray(masks[i]))
    return global_dict


def run_driver(scene, outdir: str | Path, min_conf_thr: float = 1.5,
               clean_depth: bool = True, filter_pct: bool = True) -> dict:
    """collect + export + pickle global_params.pkl for an optimized scene."""
    geo = collect_geometry(scene, min_conf_thr, clean_depth)
    imgs, pts3d, masks, focals, cams2world, depths, depths_max = geo
    outdir = Path(outdir)
    global_dict = export_geometry(outdir, imgs, pts3d, masks, focals,
                                  cams2world, depths, depths_max, filter_pct)
    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir / "global_params.pkl", "wb") as f:
        pickle.dump(global_dict, f)
    return global_dict


def scene_graph_string(scenegraph_type: str, winsize: int,
                       win_cyclic: bool, refid: int = 0) -> str:
    """The dust3r-style scene-graph spec ("swin-10-noncyclic") fed to the
    external matcher when the gated path runs (`run.py:254-263`)."""
    parts = [scenegraph_type]
    if scenegraph_type in ("swin", "logwin"):
        parts.append(str(winsize))
        if not win_cyclic:
            parts.append("noncyclic")
    elif scenegraph_type == "oneref":
        parts.append(str(refid))
    return "-".join(parts)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.mast3r_driver",
        description="Print the matcher's pair graph and scene-graph string "
                    "for a clip of --num_files frames (the driver's "
                    "functions are a library for run_mast3r).")
    p.add_argument("--num_files", type=int, required=True)
    p.add_argument("--scenegraph_type", default="swin",
                   choices=["swin", "logwin", "oneref"])
    p.add_argument("--winsize", type=int, default=10)
    p.add_argument("--win_cyclic", action="store_true")
    p.add_argument("--refid", type=int, default=0)
    return p


if __name__ == "__main__":
    a = build_parser().parse_args()
    w = clamp_winsize(a.num_files, a.scenegraph_type, a.win_cyclic, a.winsize)
    print(scene_graph_string(a.scenegraph_type, w, a.win_cyclic, a.refid))
    print(build_pair_graph(a.num_files, a.scenegraph_type, w, a.win_cyclic,
                           a.refid))
