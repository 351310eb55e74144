"""State conversion between the JAX package and the port.

The JAX package's state (`GaussianStore`, `CameraPoses`, `AdamState`,
`DensifyStats`) arrives as numpy arrays: a mapping of field name -> array,
or any NamedTuple-like object with `_asdict()` whose leaves convert with
`np.asarray`. The port's tensors go back out as dicts of numpy arrays with
the same field names, so both sides can step from identical state. Nothing
here imports JAX.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .models.gaussians import GaussianParams, GaussianStore
from .train.densify import DensifyStats
from .train.optim import AdamState, CameraPoses
from .utils.platform import resolve_device


def _fields(obj) -> Mapping[str, Any]:
    return obj._asdict() if hasattr(obj, "_asdict") else obj


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.array(x), device=device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _tuple_from(cls, obj, device):
    f = _fields(obj)
    return cls(*[_tensor(f[name], device) for name in cls._fields])


def _tuple_to(t) -> dict[str, np.ndarray]:
    return {name: _to_numpy(x) for name, x in t._asdict().items()}


def store_from_numpy(obj, device=None) -> GaussianStore:
    """GaussianStore from `{params: {xyz, ...}, alive, time, time_ind}`."""
    dev = resolve_device(device)
    f = _fields(obj)
    return GaussianStore(
        params=_tuple_from(GaussianParams, f["params"], dev),
        alive=_tensor(f["alive"], dev).to(torch.bool),
        time=_tensor(f["time"], dev),
        time_ind=_tensor(f["time_ind"], dev).to(torch.int32),
    )


def store_to_numpy(store: GaussianStore) -> dict:
    return {"params": _tuple_to(store.params), "alive": _to_numpy(store.alive),
            "time": _to_numpy(store.time),
            "time_ind": _to_numpy(store.time_ind)}


def poses_from_numpy(obj, device=None) -> CameraPoses:
    return _tuple_from(CameraPoses, obj, resolve_device(device))


def poses_to_numpy(poses: CameraPoses) -> dict:
    return _tuple_to(poses)


def adam_from_numpy(obj, like: type, device=None) -> AdamState:
    """AdamState whose moments are `like` NamedTuples (GaussianParams or
    CameraPoses)."""
    dev = resolve_device(device)
    f = _fields(obj)
    return AdamState(mu=_tuple_from(like, f["mu"], dev),
                     nu=_tuple_from(like, f["nu"], dev),
                     count=_tensor(f["count"], dev).to(torch.int32))


def adam_to_numpy(state: AdamState) -> dict:
    return {"mu": _tuple_to(state.mu), "nu": _tuple_to(state.nu),
            "count": _to_numpy(state.count)}


def stats_from_numpy(obj, device=None) -> DensifyStats:
    return _tuple_from(DensifyStats, obj, resolve_device(device))


def stats_to_numpy(stats: DensifyStats) -> dict:
    return _tuple_to(stats)
