"""Frozen copy of `rodygs_tpu_torch/ops/sh.py` (the parts the
benchmark's plain reference uses): later changes to the program do not
reach it. The original docstring follows.

Spherical-harmonics evaluation (degrees 0..4), RGB<->SH DC conversion.

Port of `rodygs_tpu/ops/sh.py` (the constants are copied, not imported).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


