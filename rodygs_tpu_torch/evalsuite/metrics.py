"""Image quality metrics: PSNR / SSIM / MS-SSIM / DSSIM / LPIPS. Port of
`rodygs_tpu/evalsuite/metrics.py` (channels-last [H, W, C] images in
[0, 1]).

  * PSNR is the training ops' (ops/image.py); the evaluation SSIM takes
    VALID windows like piqa, where the training loss keeps the reference
    trainer's zero-padded SAME blur. The VALID blur is two `conv2d` passes
    (the JAX package computes it with `lax.conv`, outside any kernel), in
    full fp32 on the card: the device is resolved through
    `resolve_device`, which turns cuDNN's TF32 off.
  * MS-SSIM: the 5-scale Wang et al. weights with 2x average-pool
    downsampling; the level count adapts to the image and the weights are
    renormalised over the kept levels.
  * LPIPS: lpips.py; the lpipsa / lpipsv keys are left out without weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.image import _gaussian_window, psnr
from ..utils.platform import resolve_device
from .lpips import lpips_fn

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _blur_valid(img: torch.Tensor, window_size: int = 11,
                sigma: float = 1.5) -> torch.Tensor:
    """Separable Gaussian blur with VALID padding, [H, W, C]."""
    w = torch.from_numpy(_gaussian_window(window_size, sigma).copy()).to(
        img.device)
    x = img.permute(2, 0, 1)[:, None]                    # [C, 1, H, W]
    x = F.conv2d(x, w.reshape(1, 1, window_size, 1))
    x = F.conv2d(x, w.reshape(1, 1, 1, window_size))
    return x[:, 0].permute(1, 2, 0)


def _ssim_cs(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11, sigma: float = 1.5):
    """Returns (mean luminance*cs term, mean cs term), VALID windows."""
    c = img1.shape[2]
    b = _blur_valid(torch.cat([img1, img2, img1 * img1, img2 * img2,
                               img1 * img2], dim=2), window_size, sigma)
    mu1, mu2 = b[..., 0:c], b[..., c:2 * c]
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = b[..., 2 * c:3 * c] - mu1_sq
    s2 = b[..., 3 * c:4 * c] - mu2_sq
    s12 = b[..., 4 * c:5 * c] - mu12
    c1, c2 = 0.01**2, 0.03**2
    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return torch.mean(ssim_map), torch.mean(cs_map)


def ssim_eval(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return _ssim_cs(img1, img2)[0]


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    """2x average pool, odd dimensions edge-padded first, [H, W, C]."""
    h, w, c = img.shape
    if h % 2 or w % 2:
        # replicate padding needs a batched [N, C, H, W] input
        img = F.pad(img.permute(2, 0, 1)[None], (0, w % 2, 0, h % 2),
                    mode="replicate")[0].permute(1, 2, 0)
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return img.reshape(h2, 2, w2, 2, c).mean(dim=(1, 3))


def ms_ssim_levels(height: int, width: int) -> int:
    """Scale count the adaptive MS-SSIM uses for an image of these dims:
    each level needs the 11-tap window to fit after the 2x downsamplings.
    Below 5 levels the msssim/dssim values are not piqa-comparable; the
    evaluator says so in result.yaml."""
    min_dim = min(height, width)
    levels = 1
    while levels < len(_MSSSIM_WEIGHTS) and (min_dim >> levels) >= 11:
        levels += 1
    return levels


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """MS-SSIM (Wang et al. 2003) with piqa's 5-scale weights, the level
    count adapted to the image and the weights renormalised over the
    kept levels."""
    levels = ms_ssim_levels(img1.shape[0], img1.shape[1])
    weights = np.asarray(_MSSSIM_WEIGHTS[:levels])
    weights = weights / weights.sum()
    mcs = []
    val = None
    for i in range(levels):
        ssim_val, cs = _ssim_cs(img1, img2)
        if i == levels - 1:
            val = torch.clamp(ssim_val, min=0.0)
        else:
            mcs.append(torch.clamp(cs, min=0.0))
            img1 = _downsample2(img1)
            img2 = _downsample2(img2)
    out = val ** float(weights[-1])
    for w, cs in zip(weights[:-1], mcs):
        out = out * cs ** float(w)
    return out


class VizScoreEvaluator:
    """psnr / ssim / msssim / dssim / lpips (alex + vgg) per image pair, on
    `device` (`cuda` unless the caller asks for the CPU)."""

    def __init__(self, lpips_weights: str | None = None, device=None):
        self.device = resolve_device(device)
        self._lpips_alex = lpips_fn("alex", lpips_weights, self.device)
        self._lpips_vgg = lpips_fn("vgg", lpips_weights, self.device)

    @torch.no_grad()
    def _core(self, gt: torch.Tensor, pred: torch.Tensor) -> dict:
        gt = torch.clamp(gt, 0.0, 1.0)
        pred = torch.clamp(pred, 0.0, 1.0)
        msssim = ms_ssim(gt, pred)
        return {
            "psnr": psnr(pred, gt),
            "ssim": ssim_eval(gt, pred),
            "msssim": msssim,
            "dssim": (1.0 - msssim) / 2.0,
        }

    def get_score(self, gt_image, pred_image) -> dict[str, float]:
        """gt / pred: [H, W, 3] numpy arrays or tensors."""
        gt = torch.as_tensor(gt_image, dtype=torch.float32, device=self.device)
        pred = torch.as_tensor(pred_image, dtype=torch.float32,
                               device=self.device)
        out = {k: float(v) for k, v in self._core(gt, pred).items()}
        # lpips keys appear only when weights are available (lpips.py)
        if self._lpips_alex is not None:
            out["lpipsa"] = float(self._lpips_alex(gt, pred))
        if self._lpips_vgg is not None:
            out["lpipsv"] = float(self._lpips_vgg(gt, pred))
        return out
