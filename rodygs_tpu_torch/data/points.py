"""Point-cloud containers and ops. Port of `rodygs_tpu/data/points.py`
(numpy, unchanged): `uniform_sample` draws with the same
`np.random.default_rng(seed)` call, so both packages start from the same
point cloud."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BasicPointCloud:
    points: np.ndarray               # [N, 3]
    colors: np.ndarray               # [N, 3] in [0, 1]
    normals: np.ndarray              # [N, 3]
    time: np.ndarray | None = None   # [N] or [N, 1]


def uniform_sample(pcd: BasicPointCloud, ratio: float,
                   seed: int = 0) -> BasicPointCloud:
    """Uniform random downsample by `ratio` (reference `uniform_sample`)."""
    n = len(pcd.points)
    k = int(n * ratio)
    idx = np.random.default_rng(seed).choice(n, size=k, replace=False)
    return BasicPointCloud(
        points=pcd.points[idx],
        colors=pcd.colors[idx],
        normals=pcd.normals[idx],
        time=None if pcd.time is None else np.asarray(pcd.time).reshape(-1)[idx],
    )


def merge_pcds(pcds: list[BasicPointCloud]) -> BasicPointCloud:
    return BasicPointCloud(
        points=np.concatenate([p.points for p in pcds]),
        colors=np.concatenate([p.colors for p in pcds]),
        normals=np.concatenate([p.normals for p in pcds]),
        time=(None if pcds[0].time is None else
              np.concatenate([np.asarray(p.time).reshape(-1) for p in pcds])),
    )
