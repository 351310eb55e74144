"""16-bit PNG storers and the mp4 export. Port of
`rodygs_tpu/utils/store.py` (`RGBStorer`, `AssetStorer`, `write_video`).

An image is clamped to [0, 1] and scaled to 16 bits by truncation, as the
JAX package's numpy path does (`rodygs_tpu/utils/native.py:109-110`), and
written by `cv2.imwrite` in BGR order, as the reference writes it.
"""

from __future__ import annotations

import glob
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np


def to_u16(image: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> uint16 (clamped, truncated)."""
    return (np.clip(image, 0.0, 1.0) * 65535.0).astype(np.uint16)


class RGBStorer:
    """[H, W, 3] float image in [0, 1] -> 16-bit PNG.

    Writes go through a small thread pool by default (cv2 releases the
    interpreter lock), so encoding overlaps the evaluator's render and
    score loop. Call `flush()` before reading the files back."""

    def __init__(self, path: Path, workers: int = 4):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self._pool = ThreadPoolExecutor(workers) if workers > 0 else None
        self._pending = []

    def _write(self, out_path: Path, image: np.ndarray) -> None:
        if not cv2.imwrite(str(out_path), to_u16(image)[..., ::-1]):
            raise OSError(f"cv2 could not write {out_path}")

    def __call__(self, image_name: str, image: np.ndarray) -> None:
        image = np.ascontiguousarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected [H,W,3], got {image.shape}")
        out = self.path / image_name
        if self._pool is None:
            self._write(out, image)
        else:
            self._pending.append(self._pool.submit(self._write, out, image))

    def flush(self) -> None:
        """Wait for queued writes; re-raise the first failure."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()


class AssetStorer:
    """gt/pred directory layout: `<out>/viz/<name>.png`."""

    def __init__(self, out_path: Path):
        self.out_path = Path(out_path)
        self.out_path.mkdir(parents=True, exist_ok=True)
        self.viz_storer = RGBStorer(self.out_path / "viz")

    def __call__(self, image_name: str, image: np.ndarray) -> None:
        self.viz_storer(image_name, image)

    def flush(self) -> None:
        self.viz_storer.flush()


def write_video(frames_dir: Path, video_path: Path, fps: int = 30) -> None:
    """Collect `*.png` under frames_dir, in name order, into an mp4.
    imageio with libx264 where it is installed (the reference's path),
    else OpenCV's mp4v encoder."""
    paths = sorted(glob.glob(os.path.join(str(frames_dir), "*.png")))
    if not paths:
        return

    def load(p):
        img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        if img.dtype == np.uint16:
            img = (img / 257).astype(np.uint8)
        return img  # BGR

    try:
        import imageio

        with imageio.get_writer(str(video_path), fps=fps, codec="libx264") as w:
            for p in paths:
                w.append_data(load(p)[..., ::-1])
        return
    except Exception:
        pass
    h, w_ = load(paths[0]).shape[:2]
    vw = cv2.VideoWriter(str(video_path), cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (w_, h))
    for p in paths:
        vw.write(load(p))
    vw.release()
