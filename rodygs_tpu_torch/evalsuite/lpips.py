"""LPIPS perceptual distance (AlexNet / VGG16 backbones). Port of
`rodygs_tpu/evalsuite/lpips.py`.

The conventions are the JAX package's (the reference's local LPIPS):

  * inputs are [0, 1] images z-scored directly with the shift/scale
    constants, with no rescale to [-1, 1] first;
  * AlexNet pooling is MaxPool2d(kernel=3, stride=2), VGG16's
    MaxPool2d(2, 2);
  * features are normalised as `x / (||x||_2 + 1e-10)` (eps on the norm);
  * each tap layer's head is a 1x1 linear map without bias, then a spatial
    mean; the layers' values add up.

Weights come from a local `.npz` in the JAX package's layout
(`{net}/conv{i}/w`, `{net}/conv{i}/b`, `{net}/lin{i}/w`, `shift`, `scale`),
given as a path or by `RODYGS_LPIPS_WEIGHTS`. Without weights `lpips_fn`
returns None, with a one-time warning, and callers leave the metric out.

The convolutions run through cuDNN on the card, in full fp32 (the device
is resolved through `resolve_device`, which turns TF32 off).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.platform import resolve_device

# (out_channels, kernel, stride, pad) per conv; pool placed BEFORE the
# listed conv indices; which conv outputs (post-relu) feed LPIPS heads.
_ALEX_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
               (256, 3, 1, 1), (256, 3, 1, 1)]
_ALEX_POOL_BEFORE = {1, 2}  # torchvision alexnet: MaxPool2d(3, stride=2)
_ALEX_TAPS = [0, 1, 2, 3, 4]

_VGG_CONVS = [(64, 3, 1, 1), (64, 3, 1, 1),
              (128, 3, 1, 1), (128, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1),
              (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1),
              (512, 3, 1, 1), (512, 3, 1, 1), (512, 3, 1, 1)]
_VGG_POOL_BEFORE = {2, 4, 7, 10}  # MaxPool2d(2, 2)
_VGG_TAPS = [1, 3, 6, 9, 12]  # relu1_2, relu2_2, relu3_3, relu4_3, relu5_3


def _features(net: str, params: dict, x: torch.Tensor) -> list:
    convs = _ALEX_CONVS if net == "alex" else _VGG_CONVS
    pools = _ALEX_POOL_BEFORE if net == "alex" else _VGG_POOL_BEFORE
    pool_k, pool_s = (3, 2) if net == "alex" else (2, 2)
    taps = _ALEX_TAPS if net == "alex" else _VGG_TAPS
    feats = []
    for i, (_, _, stride, pad) in enumerate(convs):
        if i in pools:
            x = F.max_pool2d(x, pool_k, pool_s)
        x = F.relu(F.conv2d(x, params[f"conv{i}/w"], params[f"conv{i}/b"],
                            stride=stride, padding=pad))
        if i in taps:
            feats.append(x)
    return feats


@torch.no_grad()
def lpips_forward(net: str, params: dict, img1: torch.Tensor,
                  img2: torch.Tensor) -> torch.Tensor:
    """img1/img2: [H, W, 3] in [0, 1] on the params' device -> [] distance."""
    shift, scale = params["shift"], params["scale"]

    def prep(im):
        im = (torch.clamp(im, 0.0, 1.0) - shift) / scale
        return im.permute(2, 0, 1)[None]            # [1, 3, H, W]

    total = torch.zeros((), device=img1.device)
    f1 = _features(net, params, prep(img1))
    f2 = _features(net, params, prep(img2))
    for i, (a, b) in enumerate(zip(f1, f2)):
        a = a / (torch.sqrt(torch.sum(a * a, dim=1, keepdim=True)) + 1e-10)
        b = b / (torch.sqrt(torch.sum(b * b, dim=1, keepdim=True)) + 1e-10)
        d = (a - b) ** 2
        lin = params[f"lin{i}/w"]
        total = total + torch.mean(torch.sum(d * lin[None, :, None, None],
                                             dim=1))
    return total


def write_random_weights(path, seed: int = 3) -> None:
    """Seeded random weights of both nets in the converter's `.npz` layout
    (He-normal convs, N(0, 0.05) biases, U(0, 0.2) heads, the reference's
    shift and scale): the metric's numbers mean nothing, but its path runs
    without the real weights."""
    rng = np.random.default_rng(seed)
    arrays = {"shift": np.array([-0.030, -0.088, -0.188], np.float32),
              "scale": np.array([0.458, 0.448, 0.450], np.float32)}
    for net, convs, taps in (("alex", _ALEX_CONVS, _ALEX_TAPS),
                             ("vgg", _VGG_CONVS, _VGG_TAPS)):
        cin = 3
        for i, (cout, k, _, _) in enumerate(convs):
            arrays[f"{net}/conv{i}/w"] = rng.normal(
                0, (2.0 / (cin * k * k)) ** 0.5,
                size=(cout, cin, k, k)).astype(np.float32)
            arrays[f"{net}/conv{i}/b"] = rng.normal(
                0, 0.05, size=(cout,)).astype(np.float32)
            cin = cout
        for j, tap in enumerate(taps):
            arrays[f"{net}/lin{j}/w"] = rng.uniform(
                0, 0.2, size=(convs[tap][0],)).astype(np.float32)
    np.savez(path, **arrays)


_warned = set()


def load_params(net: str, weights_path: str | None, device) -> dict | None:
    """The net's weights from the .npz on `device`, or None when the file is
    missing or holds no conv weights of that net."""
    path = weights_path or os.environ.get("RODYGS_LPIPS_WEIGHTS")
    if not (path and os.path.exists(path)):
        return None
    with np.load(path) as raw:
        prefix = f"{net}/"
        params = {k[len(prefix):]: torch.tensor(raw[k], device=device)
                  for k in raw.files if k.startswith(prefix)}
        for common in ("shift", "scale"):
            if common in raw.files:
                params[common] = torch.tensor(raw[common], device=device)
    if not any(k.startswith("conv") for k in params):
        return None
    return params


def lpips_fn(net: str = "alex", weights_path: str | None = None,
             device=None):
    """Returns a callable (gt [H,W,3], pred [H,W,3]) -> [] distance tensor on
    `device` (`cuda` unless the caller asks for the CPU), or None (with a
    one-time warning) if weights are unavailable; callers omit the metric
    in that case. Images may be numpy arrays or tensors."""
    dev = resolve_device(device)
    params = load_params(net, weights_path, dev)
    if params is None:
        if net not in _warned:
            _warned.add(net)
            warnings.warn(
                f"LPIPS({net}) weights unavailable (set "
                "RODYGS_LPIPS_WEIGHTS to a converted .npz); the lpips "
                "metric will be omitted.")
        return None

    def fn(img1, img2):
        return lpips_forward(
            net, params,
            torch.as_tensor(img1, dtype=torch.float32, device=dev),
            torch.as_tensor(img2, dtype=torch.float32, device=dev))
    return fn
