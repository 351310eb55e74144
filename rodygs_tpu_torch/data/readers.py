"""Asset readers for the RoDyGS dataset layout. Port of
`rodygs_tpu/data/readers.py`: `GTCameraReader` alone, the JSON reader of the
GT train poses the evaluator scores against. The image, depth, mask and
point-cloud readers wait for the host layer (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import json
import os

import numpy as np


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
