"""Checkpoint IO in the JAX package's on-disk format. Port of
`rodygs_tpu/utils/checkpoint.py`.

A file is ``RODYGS-CKPT-v2\\n<sha256-hex>\\n<pickle payload>``; the payload
is the dict ``{"format": "rodygs_tpu.v2", "leaves": [...], "treedef": ...,
"iteration": ...}``: `leaves` the numpy arrays and scalars of the state in
JAX pytree order (dict keys sorted, NamedTuple fields in order, None no
leaf) and `treedef` the state's structure with each leaf replaced by its
index. Files move both ways between the two packages:

  * the port writes its pytree NamedTuples (`rodygs_tpu_torch.<m>.<Name>`)
    under the JAX package's names (`rodygs_tpu.<m>.<Name>`), through a
    pickler that writes those names without importing them; the JAX
    loader's restricted unpickler accepts nothing else;
  * the port reads `rodygs_tpu.<m>.<Name>` as its own
    `rodygs_tpu_torch.<m>.<Name>` when that is a NamedTuple, or as a plain
    tuple when the port has no such class, without importing the JAX
    package.

The load path hardens like the JAX one: the SHA-256 of the payload is
checked before a byte of it is parsed, and a restricted unpickler resolves
only an exact allowlist of numpy reconstruction globals, NamedTuple pytree
nodes and a safe builtins subset; any other global (`os.system`, a
callable inside an allowed package) raises `pickle.UnpicklingError`.
Legacy v1 files (the raw pickle) load through the same unpickler.
"""

from __future__ import annotations

import hashlib
import importlib
import io
import pickle
from pathlib import Path
from typing import Any

import numpy as np
import torch

_MAGIC = b"RODYGS-CKPT-v2\n"
_FORMAT = "rodygs_tpu.v2"
_PORT_ROOT = "rodygs_tpu_torch"
_FILE_ROOT = "rodygs_tpu"    # the package whose names the files carry

_ALLOWED_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    # numpy 1.x module path and the numpy 2.x `_core` rename
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    # pickle protocol 5 array path (buffer-backed reconstruction)
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}
_ALLOWED_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "complex",
                     "bytearray", "range", "slice", "bool", "int", "float",
                     "str", "bytes", "NoneType"}
_ALLOWED_COLLECTIONS = {"OrderedDict", "defaultdict", "deque"}


def _is_namedtuple_class(obj: Any) -> bool:
    return (isinstance(obj, type) and issubclass(obj, tuple)
            and hasattr(obj, "_fields"))


class _TupleNode(tuple):
    """Stand-in for a JAX-package NamedTuple the port has no class for: the
    unpickler's `cls.__new__(cls, *fields)` gives a plain tuple."""

    def __new__(cls, *fields):
        return tuple(fields)


def _port_class(module: str, name: str):
    """The port's class for the JAX package's `module.name`: its own
    NamedTuple of that name, else the tuple stand-in. Raises for a port
    object of that name that is not a NamedTuple."""
    port_module = _PORT_ROOT + module[len(_FILE_ROOT):]
    try:
        obj = getattr(importlib.import_module(port_module), name)
    except (ImportError, AttributeError):
        return _TupleNode
    if not _is_namedtuple_class(obj):
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which is no pytree "
            "node class — refusing to load")
    return obj


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if ((module, name) in _ALLOWED_GLOBALS
                or (module == "builtins" and name in _ALLOWED_BUILTINS)
                or (module == "collections" and name in _ALLOWED_COLLECTIONS)):
            return super().find_class(module, name)
        if module.partition(".")[0] == _FILE_ROOT:
            return _port_class(module, name)
        if module == "numpy.dtypes":
            obj = super().find_class(module, name)
            if isinstance(obj, type) and issubclass(obj, np.dtype):
                return obj
        raise pickle.UnpicklingError(
            f"checkpoint references disallowed global {module}.{name} — "
            "refusing to load (tampered or non-checkpoint file?)")


class _Pickler(pickle._Pickler):
    """Writes the port's NamedTuples under the JAX package's module path.
    Pickle's own `save_global` imports the module it names to check the
    class; this one writes the name alone."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "")
        if not (_is_namedtuple_class(obj)
                and module.partition(".")[0] == _PORT_ROOT):
            return super().save_global(obj, name)
        self.save(_FILE_ROOT + module[len(_PORT_ROOT):])
        self.save(obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _flatten(tree: Any, leaves: list) -> Any:
    """Append the leaves of `tree` to `leaves` in JAX pytree order (numpy
    for tensors) and return the tree with each leaf's index in its place."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _flatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        kids = [_flatten(x, leaves) for x in tree]
        if isinstance(tree, list):
            return kids
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    elif hasattr(tree, "shape"):
        tree = np.asarray(tree)
    leaves.append(tree)
    return len(leaves) - 1


def _unflatten(index_tree: Any, leaves: list) -> Any:
    if index_tree is None:
        return None
    if isinstance(index_tree, dict):
        return {k: _unflatten(v, leaves) for k, v in index_tree.items()}
    if isinstance(index_tree, (tuple, list)):
        kids = [_unflatten(x, leaves) for x in index_tree]
        if isinstance(index_tree, list):
            return kids
        return (type(index_tree)(*kids) if hasattr(index_tree, "_fields")
                else tuple(kids))
    return leaves[index_tree]


def save_checkpoint(path: str | Path, state_dict: dict, iteration: int) -> None:
    """Write `(state_dict, iteration)`; tensors are stored as numpy. The file
    is written beside its path and renamed into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    index_tree = _flatten(state_dict, leaves)
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump({
        "format": _FORMAT,
        "leaves": leaves,
        "treedef": index_tree,
        "iteration": iteration,
    })
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest().encode("ascii")
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC + digest + b"\n" + payload)
    tmp.replace(path)


def load_checkpoint(path: str | Path) -> tuple[dict, int]:
    """(state_dict, iteration) with numpy leaves; raises ValueError on a
    digest mismatch and pickle.UnpicklingError on a disallowed global."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw.startswith(_MAGIC):
        header_end = raw.index(b"\n", len(_MAGIC))
        digest = raw[len(_MAGIC):header_end].decode("ascii")
        payload = raw[header_end + 1:]
        actual = hashlib.sha256(payload).hexdigest()
        if actual != digest:
            raise ValueError(
                f"checkpoint integrity check failed for {path}: stored "
                f"sha256 {digest[:12]}… != actual {actual[:12]}… "
                "(truncated or tampered file)")
    else:
        payload = raw  # legacy v1: raw pickle, still restricted below
    obj = _RestrictedUnpickler(io.BytesIO(payload)).load()
    return _unflatten(obj["treedef"], obj["leaves"]), obj["iteration"]
