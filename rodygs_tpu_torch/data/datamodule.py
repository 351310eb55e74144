"""Dataset module: frame loading, pose containers, normalisation. Port of
`rodygs_tpu/data/datamodule.py`.

  * `DataReader` eager-loads the frames of `{train,test}_transforms.json`
    (RGBA composited over black, per-frame depth / normal / motion mask
    through the configured readers) with fixed poses.
  * `LazyDataReader`: the same loading, its poses the initial values of
    the learnable `(q_c2w [F, 4], t_c2w [F, 3])` arrays that the trainer's
    camera Adam updates.
  * `GSDataModule` wires the datasets, the samplers, the initial point
    cloud and the nerf++ normalisation used as `spatial_lr_scale`.

Host-side numpy throughout; the training loop moves a frame to the device
as a `FrameBatch` (pipelines/build.py). Rotations become quaternions
through the port's `ops/quaternion.matrix_to_quat` on CPU tensors: the same
branch-free formula, and so the same sign, as the JAX package's.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..ops.quaternion import matrix_to_quat, quat_to_matrix
from ..ops.transforms import focal2fov, fov2focal
from ..utils.config import instantiate_from_config, is_instantiable
from .points import BasicPointCloud


class FixedCameraSpec:
    """Placeholder target for the configs' `camera_config:
    src.data.utils.FixedCamera`: cameras are built functionally
    (render/camera.py); the spec only lets the YAML instantiate."""

    def __init__(self, **kwargs):
        pass


def _load_image_composite_black(path: str) -> np.ndarray:
    """RGBA -> RGB over black, [H, W, 3] float32 in [0, 1] (the native
    host-ops library when it is built, utils/native.py)."""
    from ..utils.native import composite_rgba_to_rgb, u8_rgb_to_f32

    im = Image.open(path)
    if im.mode == "RGB":
        return u8_rgb_to_f32(np.asarray(im))
    return composite_rgba_to_rgb(np.asarray(im.convert("RGBA")))


def _matrix_to_quat_np(m: np.ndarray) -> np.ndarray:
    return matrix_to_quat(torch.from_numpy(np.asarray(m, np.float32))).numpy()


class DataReader:
    """Eager frame reader with per-frame pose and fov from a configured pose
    reader. Exposes numpy frames and c2w pose arrays."""

    learnable_poses = False

    def __init__(self, dirpath: str, fname: str,
                 pose_reader: dict | None = None,
                 depth_reader: dict | None = None,
                 normal_reader: dict | None = None,
                 motion_mask_reader: dict | None = None,
                 max_depth_reader: dict | None = None,
                 ckpt_path: str | None = None,
                 camera_config: dict | None = None,
                 **kwargs):
        pose_obj = instantiate_from_config(
            pose_reader, dirpath=dirpath, fname=fname, ckpt_path=ckpt_path)
        depth_obj = (instantiate_from_config(depth_reader)
                     if is_instantiable(depth_reader) else None)
        normal_obj = (instantiate_from_config(normal_reader)
                      if is_instantiable(normal_reader) else None)
        mask_obj = (instantiate_from_config(motion_mask_reader)
                    if is_instantiable(motion_mask_reader) else None)

        with open(os.path.join(dirpath, fname)) as f:
            contents = json.load(f)

        # poses and fov serially (a pose reader may carry state); the
        # per-frame loads (PNG decode and composite, depth / normal / mask
        # reads) on a thread pool: PIL and zlib release the interpreter lock
        c2w_list, fovx_list = [], []
        for idx in range(len(contents["frames"])):
            c2w_list.append(np.asarray(pose_obj.get_poses(idx), np.float32))
            fovx_list.append(float(pose_obj.get_fovx(idx)))
        c2w = np.stack(c2w_list)

        def load_frame(idx_frame):
            idx, frame = idx_frame
            cam_name = os.path.join(dirpath, frame["file_path"])
            base_name = os.path.basename(frame["file_path"])
            fovx = fovx_list[idx]
            image = _load_image_composite_black(cam_name)
            h, w = image.shape[:2]
            fovy = float(focal2fov(fov2focal(fovx, w), h))
            mask = None if mask_obj is None else mask_obj(dirpath, base_name)
            if mask is not None and mask.shape[:2] != (h, w):
                raise ValueError(
                    f"motion mask {mask.shape[:2]} does not match image "
                    f"{(h, w)} for {base_name}")
            return {
                "image": image,
                "image_name": Path(cam_name).stem,
                "time": float(frame["time"]),
                "fovx": fovx,
                "fovy": fovy,
                "depth": None if depth_obj is None else depth_obj(dirpath, base_name),
                "normal": None if normal_obj is None else normal_obj(dirpath, base_name),
                "motion_mask": mask,
                "max_depth": None,
                "cam_idx": idx,
            }

        with ThreadPoolExecutor(max_workers=min(
                16, os.cpu_count() or 1)) as pool:
            frames = list(pool.map(load_frame,
                                   enumerate(contents["frames"])))

        self.frames = frames
        self.q_c2w = _matrix_to_quat_np(c2w[:, :3, :3])
        self.t_c2w = np.ascontiguousarray(c2w[:, :3, 3])
        self.image_height, self.image_width = frames[0]["image"].shape[:2]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int) -> dict:
        return self.frames[idx]

    def get_times(self) -> list[float]:
        return [f["time"] for f in self.frames]

    def get_poses(self) -> np.ndarray:
        """[F, 4, 4] c2w from the (possibly refined) quaternion and
        translation arrays."""
        rot = quat_to_matrix(torch.from_numpy(self.q_c2w)).numpy()
        out = np.tile(np.eye(4, dtype=np.float32), (len(self), 1, 1))
        out[:, :3, :3] = rot
        out[:, :3, 3] = self.t_c2w
        return out

    def getNerfppNorm(self) -> dict:
        """Camera-centre radius normalisation."""
        centers = self.t_c2w
        center = centers.mean(axis=0)
        diagonal = float(np.linalg.norm(centers - center, axis=1).max())
        return {"translate": -center, "radius": diagonal * 1.1}

    def normalize(self, nerf_normalization: dict) -> None:
        self.t_c2w = ((self.t_c2w + nerf_normalization["translate"])
                      / nerf_normalization["radius"]).astype(np.float32)
        # the per-frame depth priors scale with the scene (inert for the
        # scale-invariant Pearson depth losses, kept for exactness)
        radius = float(nerf_normalization["radius"])
        for f in self.frames:
            if f.get("depth") is not None:
                f["depth"] = f["depth"] / radius


class LazyDataReader(DataReader):
    """Same frame loading; poses meant for joint optimisation."""

    learnable_poses = True


class GSDataModule:
    """Builds the train / test datasets, their samplers and the initial
    point cloud."""

    def __init__(self, dirpath: str,
                 train_dset_config: dict, test_dset_config: dict,
                 train_dloader_config: dict, test_dloader_config: dict,
                 train_pcd_reader_config: dict,
                 train_pose_reader_config: dict | None = None,
                 normalize_cams: bool = False,
                 train_transform_fname: str = "train_transforms.json",
                 test_transform_fname: str = "test_transforms.json",
                 ckpt_path: str | None = None):
        self.train_dset = instantiate_from_config(
            train_dset_config, dirpath=dirpath, fname=train_transform_fname,
            ckpt_path=ckpt_path)
        self.test_dset = instantiate_from_config(
            test_dset_config, dirpath=dirpath, fname=test_transform_fname,
            ckpt_path=ckpt_path)

        self._nerf_normalization = self.train_dset.getNerfppNorm()

        self._train_sampler = instantiate_from_config(
            train_dloader_config, dataset=self.train_dset)
        self._test_sampler = instantiate_from_config(
            test_dloader_config, dataset=self.test_dset)

        self._pcd, self.skip_dynamic = instantiate_from_config(
            train_pcd_reader_config, dirpath=dirpath,
            nerf_normalization=self._nerf_normalization)()

        if train_pose_reader_config:
            self._gt_train_dset = instantiate_from_config(
                train_pose_reader_config, dirpath=dirpath,
                fname="train_transforms.json")

        if normalize_cams:
            self.train_dset.normalize(self._nerf_normalization)
            self.test_dset.normalize(self._nerf_normalization)
            self._pcd = self._normalize_pcd(self._pcd, self._nerf_normalization)
            self._nerf_normalization = self.train_dset.getNerfppNorm()

    @staticmethod
    def _normalize_pcd(pcd: BasicPointCloud, norm: dict) -> BasicPointCloud:
        pts = (pcd.points + norm["translate"][None, :]) / norm["radius"]
        return BasicPointCloud(pts, pcd.colors, pcd.normals, pcd.time)

    def get_train_dset(self) -> DataReader:
        return self.train_dset

    def get_test_dset(self) -> DataReader:
        return self.test_dset

    def get_init_pcd(self) -> BasicPointCloud:
        return self._pcd

    def get_normalization(self) -> dict:
        return self._nerf_normalization

    def get_train_sampler(self):
        return self._train_sampler

    def get_test_sampler(self):
        return self._test_sampler

    def get_gt_train_poses(self) -> np.ndarray:
        return self._gt_train_dset.get_poses()

    def get_train_poses(self) -> np.ndarray:
        return self.train_dset.get_poses()
