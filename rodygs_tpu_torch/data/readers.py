"""Asset readers for the RoDyGS dataset layout. Port of
`rodygs_tpu/data/readers.py` (host-side numpy). The on-disk contract:

    <scene>/
      train/ test/                       RGB(A) frames
      train_transforms.json              {camera_angle_x, frames:[{file_path,
      test_transforms.json                transform_matrix(c2w), time}]}
      depth_anything/<frame>.npy         DepthAnythingV2 raw depth
      tam_mask/<idx>.png|jpg             Track-Anything motion masks
      mast3r_opt/<exp>/global_params.pkl {focals, cam2worlds, ...}
      mast3r_opt/<exp>/{static,dynamic,op_results}/*.ply  per-frame clouds

Field-of-view arithmetic is done in float64 here; the JAX package does it
in float32 through XLA's `tan`/`atan`, so a fov can differ in its last
float32 bit.
"""

from __future__ import annotations

import json
import os
import pickle
import warnings
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..ops.transforms import focal2fov
from ..utils.ply import fetch_pointcloud
from .points import BasicPointCloud, merge_pcds, uniform_sample


def _load_global_params(dirpath, dirname, expname) -> dict:
    with open(Path(dirpath, dirname, expname, "global_params.pkl"), "rb") as f:
        return pickle.load(f)


def _mast3r_fovx(data: dict, img_res: int) -> float:
    return float(focal2fov(float(np.asarray(data["focals"][0])), img_res))


class GTCameraReader:
    """GT c2w poses and fovx (degrees in the json) from a transforms file
    (`{camera_angle_x, frames: [{transform_matrix, ...}]}`)."""

    def __init__(self, dirpath, fname, **kwargs):
        with open(os.path.join(dirpath, fname)) as f:
            contents = json.load(f)
        self._fovx = float(np.deg2rad(contents["camera_angle_x"]))
        self._poses = np.array(
            [frame["transform_matrix"] for frame in contents["frames"]],
            dtype=np.float32)

    def get_poses(self, idx=None):
        return self._poses if idx is None else self._poses[idx]

    def get_fovx(self, idx):
        return self._fovx


class DepthAnythingReader:
    """Negated, min-max-normalised DepthAnything `.npy` maps. Returns
    [H, W] float32."""

    prefix = "depth_anything"

    def __init__(self, **kwargs):
        pass

    def __call__(self, dirpath, basename):
        from ..utils.native import negate_minmax_normalize

        base = os.path.splitext(basename)[0] + ".npy"
        raw = np.load(Path(dirpath, self.prefix, base))
        return negate_minmax_normalize(raw.astype(np.float32))


class TAMMaskReader:
    """Binary motion masks: `<6-digit frame idx>.jpg|png` > 0. Returns
    [H, W] bool."""

    prefix = "tam_mask"

    def __init__(self, split="train", resolution=1):
        if split not in ("train", "val", "test"):
            raise ValueError(f"TAMMaskReader: unknown split {split!r}")
        self.resolution = resolution

    def __call__(self, dirpath, basename):
        stem = os.path.splitext(basename)[0]
        rgb_idx = stem.split("_")[-1].zfill(6)
        path = Path(dirpath, self.prefix, f"{rgb_idx}.jpg")
        if not path.exists():
            path = Path(dirpath, self.prefix, f"{rgb_idx}.png")
        img = Image.open(path)
        if self.resolution != 1:
            w, h = img.size
            img = img.resize((w // self.resolution, h // self.resolution),
                             Image.NEAREST)
        arr = np.asarray(img)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr > 0


class Test_MASt3RFovCameraReader:
    """GT test poses and the MASt3R-estimated fov."""

    dirname = "mast3r_opt"

    def __init__(self, dirpath, fname, mast3r_expname, mast3r_img_res, **kwargs):
        with open(os.path.join(dirpath, fname)) as f:
            contents = json.load(f)
        self._poses = np.array(
            [frame["transform_matrix"] for frame in contents["frames"]],
            dtype=np.float32)
        data = _load_global_params(dirpath, self.dirname, mast3r_expname)
        self._fovx = _mast3r_fovx(data, mast3r_img_res)

    def get_poses(self, idx=None):
        return self._poses if idx is None else self._poses[idx]

    def get_fovx(self, idx):
        return self._fovx


class MASt3RCameraReader:
    """Initial poses and fov from the MASt3R global alignment."""

    dirname = "mast3r_opt"

    def __init__(self, dirpath, mast3r_expname, mast3r_img_res, **kwargs):
        data = _load_global_params(dirpath, self.dirname, mast3r_expname)
        self._poses = np.asarray(data["cam2worlds"], dtype=np.float32)
        self._fovx = _mast3r_fovx(data, mast3r_img_res)

    def get_poses(self, idx):
        return self._poses[idx]

    def get_fovx(self, idx):
        return self._fovx


class MASt3R_CKPTCameraReader:
    """Refined poses out of a trained static checkpoint (either package's
    files, utils/checkpoint.py) and the MASt3R fov."""

    dirname = "mast3r_opt"

    def __init__(self, dirpath, ckpt_path, mast3r_expname, mast3r_img_res,
                 **kwargs):
        from ..ops.quaternion import quat_to_matrix
        from ..utils.checkpoint import load_checkpoint

        data = _load_global_params(dirpath, self.dirname, mast3r_expname)
        sd, _ = load_checkpoint(ckpt_path)
        if "camera" in sd:
            q = np.asarray(sd["camera"]["q_c2w"], np.float32)
            t = np.asarray(sd["camera"]["t_c2w"])
            rot = quat_to_matrix(torch.from_numpy(q)).numpy()
            poses = np.tile(np.eye(4, dtype=np.float32), (len(q), 1, 1))
            poses[:, :3, :3] = rot
            poses[:, :3, 3] = t
        else:
            # a converted reference checkpoint trained without camera
            # optimisation may lack the section; score the MASt3R init
            # poses those runs trained against
            warnings.warn(f"{ckpt_path} has no camera section; pose metrics "
                          "will score the MASt3R init poses")
            poses = np.asarray(data["cam2worlds"], dtype=np.float32)
        self._poses = poses
        self._fovx = _mast3r_fovx(data, mast3r_img_res)

    def get_poses(self, idx):
        return self._poses[idx]

    def get_fovx(self, idx):
        return self._fovx


class MASt3RPCDReader:
    """Merge the per-frame static / dynamic / op_results clouds, tag each
    point with its frame's time from train_transforms.json, downsample to
    `num_limit_points`. A scene without a dynamic/ directory is all static
    (`skip_dynamic`)."""

    dirname = "mast3r_opt"

    def __init__(self, dirpath, mast3r_expname, mode=None,
                 downsample_ratio=0.1, num_limit_points=None, **kwargs):
        self.skip_dynamic = False
        base = Path(dirpath, self.dirname, mast3r_expname)

        if not (base / "dynamic").exists():
            files = sorted((base / "static").glob("*.ply"))
            self.pcd = BasicPointCloud(*fetch_pointcloud(files[0]))
            self.skip_dynamic = True
            return

        subdir = {"dynamic": "dynamic", "static": "static"}.get(mode, "op_results")
        files = sorted((base / subdir).glob("*.ply"))
        pcds = []
        with open(Path(dirpath, "train_transforms.json")) as f:
            times = [fr["time"] for fr in json.load(f)["frames"]]
        for idx, path in enumerate(files):
            pts, cols, normals, _ = fetch_pointcloud(path)
            pcds.append(BasicPointCloud(
                points=pts, colors=cols, normals=normals,
                time=np.full(len(pts), times[idx], np.float32)))
        merged = merge_pcds(pcds)
        if num_limit_points is not None:
            downsample_ratio = min(num_limit_points / len(merged.points), 1.0)
        self.pcd = uniform_sample(merged, downsample_ratio)

    def __call__(self):
        return self.pcd, self.skip_dynamic
