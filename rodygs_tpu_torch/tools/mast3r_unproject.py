"""MASt3R depth unprojection and the static / dynamic split (numpy and
Pillow; no network). Port of `scripts/mast3r_unproject.py`.

    python -m rodygs_tpu_torch.tools.mast3r_unproject --datadir <scene>
        --mast3r_expname <exp> [--mask_name tam_mask]

Reads `<scene>/mast3r_opt/<exp>/global_params.pkl` ({focals, cam2worlds,
depths, max_depths, masks}, the MASt3R runner's output), unscales and
clips the depths, unprojects each frame's depth map to world points
through the inverse intrinsics and its camera-to-world matrix, splits them
by the frame's motion mask into `static/XXXX_static.ply` and
`dynamic/XXXX_dynamic.ply`, and saves `depth/XXXXX_depth.npy`. With no
mask, or only empty ones, the scene is static only. The unprojection runs
in the port's native host ops (`utils/native.py`) or in numpy.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from pathlib import Path

import numpy as np
from PIL import Image

from ..utils.native import unproject_depth_native
from ..utils.ply import write_ply

MAST3R_LONG_SIDE = 512


def resize_to_mast3r(arr: np.ndarray, img_w: int, img_h: int) -> np.ndarray:
    """Resize to the MASt3R working resolution (nearest for masks)."""
    im = Image.fromarray(arr)
    return np.asarray(im.resize((img_w, img_h), Image.NEAREST))


def unproject_depth(focal, c2w, image, depth, mask=None):
    """Pixel grid + depth -> world points and their colours (the
    reference's `unproject_depth`, `pcd_utils.py:93-120`). image [H, W, 3]
    uint8, depth [H, W]."""
    native = unproject_depth_native(np.asarray(depth, np.float32),
                                    np.asarray(c2w, np.float32), float(focal))
    if native is not None:
        colors = image.reshape(-1, 3)
        if mask is not None:
            m = mask.ravel()
            return native[m], colors[m]
        return native, colors
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    pix = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)], axis=0)  # [3,HW]
    k_inv = np.linalg.inv(
        np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]))
    rays = k_inv @ pix
    pts_cam = rays * depth.reshape(1, -1)
    colors = image.reshape(-1, 3)
    if mask is not None:
        m = mask.ravel()
        pts_cam = pts_cam[:, m]
        colors = colors[m]
    pts_world = c2w[:3, :3] @ pts_cam + c2w[:3, 3:4]
    return pts_world.T.astype(np.float32), colors


def check_all_masks_false(maskpaths) -> bool:
    return all(not np.any(np.asarray(Image.open(p))) for p in maskpaths)


def mast3r_unprojection(exp_dir, maskpaths, imagepaths, skip_dynamic):
    with open(os.path.join(exp_dir, "global_params.pkl"), "rb") as f:
        data = pickle.load(f)
    focal = float(np.asarray(data["focals"][0]))
    depth_max = float(np.asarray(data["max_depths"][0]))
    depths = np.clip(np.asarray(data["depths"]) * depth_max, 0, depth_max)
    img_h = len(data["masks"][0])
    img_w = len(data["masks"][0][0])

    static_dir = Path(exp_dir) / "static"
    depth_dir = Path(exp_dir) / "depth"
    static_dir.mkdir(exist_ok=True)
    depth_dir.mkdir(exist_ok=True)
    if not skip_dynamic:
        dynamic_dir = Path(exp_dir) / "dynamic"
        dynamic_dir.mkdir(exist_ok=True)

    for i, imgpath in enumerate(imagepaths):
        img = np.asarray(Image.open(imgpath).convert("RGB"))
        img = resize_to_mast3r(img, img_w, img_h)
        c2w = np.asarray(data["cam2worlds"][i])
        depth = depths[i].reshape(img_h, img_w)

        if skip_dynamic:
            pts, cols = unproject_depth(focal, c2w, img, depth)
            write_ply(static_dir / f"{i:04d}_static.ply", pts, colors=cols)
        else:
            mask = np.asarray(Image.open(maskpaths[i]))
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = resize_to_mast3r(mask, img_w, img_h) > 0
            pts_d, cols_d = unproject_depth(focal, c2w, img, depth, mask)
            pts_s, cols_s = unproject_depth(focal, c2w, img, depth, ~mask)
            write_ply(dynamic_dir / f"{i:04d}_dynamic.ply", pts_d, colors=cols_d)
            write_ply(static_dir / f"{i:04d}_static.ply", pts_s, colors=cols_s)
        np.save(depth_dir / f"{i:05d}_depth.npy", depth)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.mast3r_unproject",
        description="MASt3R depth maps -> static / dynamic init PLYs.")
    parser.add_argument("--datadir", required=True)
    parser.add_argument("--mast3r_expname", required=True)
    parser.add_argument("--mask_name", default="tam_mask")
    return parser


def main(args) -> None:
    exp_dir = os.path.join(args.datadir, "mast3r_opt", args.mast3r_expname)
    imagepaths = sorted(glob.glob(f"{args.datadir}/train/*.png"))
    maskpaths = sorted(glob.glob(f"{args.datadir}/{args.mask_name}/*.png")) or \
        sorted(glob.glob(f"{args.datadir}/{args.mask_name}/*.jpg"))
    skip_dynamic = not maskpaths or check_all_masks_false(maskpaths)
    if skip_dynamic:
        print("No dynamic regions found — static-only unprojection.")
    mast3r_unprojection(exp_dir, maskpaths, imagepaths, skip_dynamic)


if __name__ == "__main__":
    main(build_parser().parse_args())
