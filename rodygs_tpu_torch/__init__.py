"""rodygs_tpu_torch — the PyTorch/CUDA port of `rodygs_tpu`.

Mirrors the JAX package's module layout (`rodygs_tpu/render/compact.py` <->
`rodygs_tpu_torch/render/compact.py`, ...). The four Pallas kernels of the
rasterizer are hand-written CUDA C++ kernels for Hopper (`csrc/`), built
from source at first use (`kernels.py`); every other op is plain PyTorch.

The package imports torch, numpy, scipy (the pose metrics), PyYAML
(configs, result.yaml), Pillow (frames and masks), OpenCV (PNGs and the
video) and the standard library only — never `jax` and nothing of
`rodygs_tpu`. Entry points, the CLIs under `pipelines/` included, run on
`cuda` unless the caller asks for the CPU (`device="cpu"`, `--device cpu`;
utils/platform.resolve_device).
"""

__version__ = "0.1.0"
