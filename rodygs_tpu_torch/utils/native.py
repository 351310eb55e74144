"""ctypes loader for the native host-ops library. Port of
`rodygs_tpu/utils/native.py`.

`native/host_ops.cpp` (at the repository root, beside this package) is
compiled on first use with the system toolchain (g++ -O3 -fopenmp) into
`rodygs_tpu_torch/_build/`, keyed by a hash of the source. Without a
compiler, or without the source, every function falls back to numpy:
the native layer is host code that makes frame loading and PNG export
faster, never a dependency. `backend()` says which path runs. The first
call builds or loads the library under a lock, so threads that call in
together all see the same path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_LOCK = threading.Lock()   # the frame loader's threads call in at once

_SRC = Path(__file__).resolve().parents[2] / "native" / "host_ops.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"


def _build() -> ctypes.CDLL | None:
    if not _SRC.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"host_ops_{tag}.so"
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               "-fopenmp", str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception as e:  # no toolchain / compile error -> numpy path
            warnings.warn(f"native host_ops build failed ({e}); using numpy")
            return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.composite_rgba_to_rgb.argtypes = [u8p, f32p, i64]
    lib.u8_rgb_to_f32.argtypes = [u8p, f32p, i64]
    lib.negate_minmax_normalize.argtypes = [f32p, f32p, i64]
    lib.f32_rgb_to_u16_bgr.argtypes = [f32p, u16p, i64]
    lib.unproject_depth.argtypes = [f32p, f32p, ctypes.c_float, i64, i64, f32p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            try:
                _LIB = _build()
            except Exception as e:
                warnings.warn(f"native host_ops unavailable: {e}")
                _LIB = None
            _TRIED = True
    return _LIB


def backend() -> str:
    """"native" when the compiled library serves the calls, else "numpy"."""
    return "native" if get_lib() is not None else "numpy"


def composite_rgba_to_rgb(rgba: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 -> [H, W, 3] float32 composited over black."""
    lib = get_lib()
    h, w = rgba.shape[:2]
    if lib is not None and rgba.dtype == np.uint8:
        rgba = np.ascontiguousarray(rgba)
        out = np.empty((h, w, 3), np.float32)
        lib.composite_rgba_to_rgb(rgba, out, h * w)
        return out
    data = rgba.astype(np.float32) / 255.0
    return np.clip(data[..., :3] * data[..., 3:4], 0.0, 1.0)


def u8_rgb_to_f32(rgb: np.ndarray) -> np.ndarray:
    lib = get_lib()
    if lib is not None and rgb.dtype == np.uint8:
        rgb = np.ascontiguousarray(rgb)
        out = np.empty(rgb.shape, np.float32)
        lib.u8_rgb_to_f32(rgb, out, rgb.size)
        return out
    return rgb.astype(np.float32) / 255.0


def negate_minmax_normalize(depth: np.ndarray) -> np.ndarray:
    lib = get_lib()
    if lib is not None:
        depth = np.ascontiguousarray(depth, np.float32)
        out = np.empty_like(depth)
        lib.negate_minmax_normalize(depth, out, depth.size)
        return out
    d = -depth.astype(np.float32)
    return (d - d.min()) / max(d.max() - d.min(), 1e-20)


def f32_rgb_to_u16_bgr(img: np.ndarray) -> np.ndarray:
    lib = get_lib()
    h, w = img.shape[:2]
    if lib is not None:
        img = np.ascontiguousarray(img, np.float32)
        out = np.empty((h, w, 3), np.uint16)
        lib.f32_rgb_to_u16_bgr(img, out, h * w)
        return out
    arr = np.clip(img, 0.0, 1.0)[..., ::-1]
    return (arr * 65535.0).astype(np.uint16)


def unproject_depth_native(depth: np.ndarray, c2w: np.ndarray,
                           focal: float) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    h, w = depth.shape
    depth = np.ascontiguousarray(depth, np.float32)
    c2w = np.ascontiguousarray(c2w, np.float32)
    out = np.empty((h * w, 3), np.float32)
    lib.unproject_depth(depth, c2w, float(focal), w, h, out)
    return out
