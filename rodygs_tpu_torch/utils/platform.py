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


def device_label(device: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them for a CUDA device (the name alone when nvidia-smi cannot be run),
    "cpu" otherwise."""
    import subprocess

    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(index)
    return smi.stdout.strip()
