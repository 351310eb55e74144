"""Image-space loss math on channels-last [H, W, C] images: L1, windowed
SSIM, PSNR, Pearson depth correlation and Charbonnier. Port of
`rodygs_tpu/ops/image.py`.

SSIM uses the 11-tap sigma-1.5 separable Gaussian window with C1=0.01^2,
C2=0.03^2, and zero-padded borders. The separable blur is two banded-matrix
products, as in the JAX package, and not `conv2d`: cuDNN runs float32
convolutions in TF32 by default, while the matrix products run in full
fp32 (the entry points also turn TF32 off, utils/platform.strict_fp32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _band_matrix(n: int, window_size: int, sigma: float) -> np.ndarray:
    """[n, n] banded matrix B with B[i, i+k-pad] = w[k]: `B @ x` is the SAME
    zero-padded 1-D window conv along a length-n axis."""
    w = _gaussian_window(window_size, sigma)
    pad = window_size // 2
    b = np.zeros((n, n), np.float32)
    for k in range(window_size):
        off = k - pad
        idx = np.arange(max(0, -off), min(n, n - off))
        b[idx, idx + off] += w[k]
    b.setflags(write=False)
    return b


@functools.lru_cache(maxsize=32)
def _band_tensor(n: int, window_size: int, sigma: float,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_matrix(n, window_size, sigma).copy()).to(device)


def _blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of [H, W, C] with SAME (zero) padding, as two
    banded matrix products."""
    h, w_, c = img.shape
    bh = _band_tensor(h, window_size, sigma, img.device)
    bw = _band_tensor(w_, window_size, sigma, img.device)
    x = (bh @ img.reshape(h, w_ * c)).reshape(h, w_, c)   # blur along H
    return torch.einsum("vw,iwc->ivc", bw, x)             # blur along W


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images (reference window-conv formula,
    zero-padded borders)."""
    if img1.ndim == 2:
        img1 = img1[:, :, None]
    if img2.ndim == 2:
        img2 = img2[:, :, None]
    c = img1.shape[2]
    stacked = torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=2)
    b = _blur(stacked, window_size, sigma)
    mu1, mu2 = b[:, :, 0:c], b[:, :, c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b[:, :, 2 * c:3 * c] - mu1_sq
    sigma2_sq = b[:, :, 3 * c:4 * c] - mu2_sq
    sigma12 = b[:, :, 4 * c:5 * c] - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB; the MSE is floored at 1e-12."""
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def pearson_rows(pred: torch.Tensor, gt: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """1 - Pearson correlation along the last dim of [..., n] rows, with the
    reference's unbiased (n-1) standard deviation."""
    n = pred.shape[-1]
    pc = pred - pred.mean(dim=-1, keepdim=True)
    gc = gt - gt.mean(dim=-1, keepdim=True)
    bessel = (n / max(n - 1.0, 1.0)) ** 0.5
    pn = pc / (torch.std(pc, dim=-1, correction=0, keepdim=True) * bessel + eps)
    gn = gc / (torch.std(gc, dim=-1, correction=0, keepdim=True) * bessel + eps)
    return 1.0 - torch.mean(pn * gn, dim=-1)


def pearson_depth_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-6,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """1 - Pearson correlation of flattened depths. The mask zeroes
    masked-out entries, but mean and std are still taken over all entries
    (the reference's semantics)."""
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    if mask is not None:
        m = mask.reshape(-1).to(p.dtype)
        p = p * m
        g = g * m
    return pearson_rows(p, g, eps)


def charbonnier_loss(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-6,
                     out_norm: str = "bc") -> torch.Tensor:
    """Charbonnier (smooth L1) summed, then normalised per `out_norm`: 'b'
    divides by dim 0, 'c' by dim 1, 'i' by the last two dims."""
    loss = torch.sum(torch.sqrt((x - y) ** 2 + eps**2))
    norm = 1.0
    if "b" in out_norm:
        norm /= x.shape[0]
    if "c" in out_norm:
        norm /= x.shape[1]
    if "i" in out_norm:
        norm /= x.shape[-1] * x.shape[-2]
    return loss * norm
