"""Tile-grid constants. Port of the part of `rodygs_tpu/render/binning.py`
that the compact path uses; the legacy broadcast-tier `bin_splats` path is
not ported."""

from __future__ import annotations

TILE = 16          # pixels per tile side
CHUNK = 128        # fragments per compositing chunk of the JAX kernels


def tile_grid(image_width: int, image_height: int) -> tuple[int, int]:
    return -(-image_width // TILE), -(-image_height // TILE)
