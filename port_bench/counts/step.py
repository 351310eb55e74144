"""FP32 operations of one joint iteration outside the tile compositors,
from shapes: the SSIM windows, the Pearson correlations and the motion
basis (its MLP and the coefficient products). An FMA counts as two. The
rigidity KNN's distance products are left out: a KNN needs far fewer than
the brute-force pairs, so they are not work the algorithm needs.

* SSIM of two [H, W, 3] images blurs 15 planes (two images, their
  squares, their product) with an 11-tap separable window: 2 passes x 11
  taps x 2 operations per plane pixel; its backward blurs the cotangents
  once more.
* Pearson over n values: centring, deviations, normalising and the mean
  product, ~10 operations a value pair forward and 20 backward.
* Motion basis MLP (netwidth W, basis B, embedding D): D*W + W*W + W*W/2 +
  B*(W/2*W/4 + W/4*7) multiply-adds per time point, x3 with its backward;
  the coefficient products C*B*7 per time point they are applied at.
"""

from __future__ import annotations

SSIM_PLANES = 15
SSIM_TAPS = 11
PEARSON_OPS = 30


def ssim_ops(width: int, height: int) -> int:
    fwd = 2 * SSIM_TAPS * 2 * SSIM_PLANES * width * height
    return 2 * fwd


def pearson_ops(n: int) -> int:
    return PEARSON_OPS * n


def mlp_ops(netwidth: int, num_basis: int, embed_dim: int,
            points: int) -> int:
    w, b = netwidth, num_basis
    macs = (embed_dim * w + w * w + w * (w // 2)
            + b * ((w // 2) * (w // 4) + (w // 4) * 7))
    return 3 * 2 * macs * points


def coefficient_ops(capacity: int, num_basis: int, points: int) -> int:
    return 3 * 2 * capacity * num_basis * 7 * points
