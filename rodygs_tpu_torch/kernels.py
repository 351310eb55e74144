"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded through `ctypes` (pointers from
`Tensor.data_ptr()`, the stream from `torch.cuda.current_stream()`). The
libraries are built from the sources at first use, all `nvcc` processes
started together, into `rodygs_tpu_torch/_build/` (listed in .gitignore),
keyed by a hash of the source, the headers and the flags so an edited
source rebuilds.

Nothing here runs at import: the CPU tests import every module, so an
import must need neither `nvcc` nor a card.

`KERNELS` names the renderer's four, which every render launches.
`csrc/knn.cu` (ops/knn.py's `knn` on the card) is not among them: it runs
only where a rigidity loss or a scale prior asks for neighbours. Nor is
`csrc/preprocess.cu` (render/preprocess.py's projection stage), one library
with three entry points: `preprocess_fwd`, `preprocess_bwd` and
`preprocess_reduce` (the camera gradient's fixed-order sum).
`LAUNCHES[name]` counts launches of the four, of `knn` and of the three
preprocess entries; `launch` adds one for each, and nothing else does.
`reset_launches()` zeroes them.
`csrc/launch_floor.cu` is no kernel of the port: it holds the empty kernel
whose time is the floor under any few-microsecond kernel
(`launch("launch_floor", blocks, threads)`), and is not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# FMA contraction stays on; the few operations that decide a pixel's stop
# are written with explicitly rounded intrinsics instead (csrc/common.cuh).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point and its argument types, per kernel source. Every entry
# returns cudaGetLastError() after its launch.
_SIGNATURES = {
    "expand": ("rodygs_expand",
               # table, nw, bases, num_chunks, f_kept, tiles_x, db,
               # rows_mode, n_rows, key, rec, stream
               (_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P)),
    "tile_fwd": ("rodygs_tile_fwd",
                 # records, P, starts, counts, offset, T, tiles_x, normals,
                 # out, stream
                 (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P)),
    "tile_bwd": ("rodygs_tile_bwd",
                 # records, P, starts, counts, offset, T, tiles_x, normals,
                 # out, gout, d_records, stream
                 (_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P)),
    "segsum": ("rodygs_segsum",
               # d, n_rows, C, off_row, nw, bases, f_kept, out, stream
               (_P, _I, _I, _P, _I, _P, _P, _P, _P)),
}
KERNELS = tuple(_SIGNATURES)
# query, n, targets, m, valid (or null), k, out_d, out_i, stream
_SIGNATURES["knn"] = ("rodygs_knn", (_P, _I, _P, _I, _P, _I, _P, _P, _P))
# means, scales, quats, shs, n, K, deg, alive, colors, opac, w2c,
# full_proj, campos, fovx, fovy, W, H, scale_modifier, mean2d, conic, depth,
# rgb, normal, radius, visible, ext, stream
_SIGNATURES["preprocess_fwd"] = (
    "rodygs_preprocess_fwd", (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P))
# means, scales, quats, shs, n, K, deg, alive, w2c, full_proj, campos, fovx,
# fovy, W, H, scale_modifier, g_mean2d, ld, g_conic, ld, g_depth, g_rgb, ld,
# g_normal, ld, d_means, d_scales, d_quats, d_shs, partial, stream
_SIGNATURES["preprocess_bwd"] = (
    "rodygs_preprocess_bwd", (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _I, _I, _F, _P, _I, _P, _I, _P, _P, _I, _P,
                              _I, _P, _P, _P, _P, _P, _P))
# partial, rows, d_w2c, d_full_proj, d_campos, stream
_SIGNATURES["preprocess_reduce"] = ("rodygs_preprocess_reduce",
                                    (_P, _I, _P, _P, _P, _P))
# the source that holds an entry point, where its name is not the entry's
_SOURCE = {name: "preprocess" for name in
           ("preprocess_fwd", "preprocess_bwd", "preprocess_reduce")}
# blocks, threads, stream: an empty kernel, launched as the others are
_SIGNATURES["launch_floor"] = ("rodygs_launch_floor", (_I, _I, _P))
LAUNCHES = {name: 0 for name in (*KERNELS, "knn", *_SOURCE)}
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _source(name: str) -> str:
    return _SOURCE.get(name, name)


def build_all() -> float:
    """Compile every missing kernel library, one nvcc per source, all in
    parallel. Returns the wall seconds spent; raises on any failure. The
    compiler's output (ptxas -v: registers, shared memory, spills) is kept
    in BUILD_LOG."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sorted({_source(entry) for entry in _SIGNATURES}):
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _cdll(name: str) -> ctypes.CDLL:
    """The library that holds entry point `name`, loaded with the argument
    types of every entry it holds."""
    src = _source(name)
    lib = _libs.get(src)
    if lib is None:
        path = _lib_path(src)
        if not path.exists():
            build_all()
        lib = _libs[src] = ctypes.CDLL(str(path))
        for entry, (sym, argtypes) in _SIGNATURES.items():
            if _source(entry) == src:
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream with C arguments `args`
    (tensors are passed by data pointer, ints as int). Raises if the launch
    reports an error; counts the launch."""
    fn = getattr(_cdll(name), _SIGNATURES[name][0])
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    if name in LAUNCHES:
        LAUNCHES[name] += 1


def blocks_per_sm(name: str, variant: int) -> int:
    """Resident blocks per SM of one instantiation of a kernel, as the CUDA
    runtime counts them from its registers, its static and dynamic shared
    memory and its threads. `variant` picks the instantiation: the tile
    kernels' include_normal; expand's 2 * rows_mode + (13 rows emitted);
    segsum's (13 rows summed); knn's (k = 8)."""
    fn = getattr(_cdll(name), f"{_SIGNATURES[name][0]}_blocks_per_sm")
    fn.argtypes, fn.restype = (_I,), ctypes.c_int
    blocks = fn(int(variant))
    if blocks < 0:
        raise RuntimeError(f"occupancy query of {name} failed: error {-blocks}")
    return blocks


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, rank, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
