"""Device selection for the port's entry points.

Entry points run on `cuda` unless the caller asks for the CPU explicitly
(`device="cpu"`, as the tests do). A missing card is an error, never a
silent move to the CPU.

Numerics: float32 matrix products and convolutions must run in full fp32.
PyTorch's default leaves cuDNN convolutions on TF32 (about three decimal
digits), so `resolve_device` turns TF32 off for both matmuls and cuDNN
whenever it hands out a CUDA device.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Disable TF32 for float32 matmuls and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` by default; raises when
    CUDA is requested (explicitly or by default) but not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rodygs_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run on the CPU explicitly")
        strict_fp32()
    return dev
