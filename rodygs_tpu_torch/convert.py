"""State conversion between the JAX package and the port.

The JAX package's state (`GaussianStore`, `CameraPoses`, `AdamState`,
`DensifyStats`, `DensifyInfo`, and the dynamic model's motion-net dict,
motion coefficients and `DynTrainState` with its Adam moments) arrives as
numpy arrays: a mapping of field name -> array,
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
from .train.densify import DensifyInfo, DensifyStats
from .train.optim import AdamState, CameraPoses
from .train.trainer_dynamic import DynParams, DynTrainState
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


def densify_info_from_numpy(obj, device=None) -> DensifyInfo:
    return _tuple_from(DensifyInfo, obj, resolve_device(device))


def densify_info_to_numpy(info: DensifyInfo) -> dict:
    return _tuple_to(info)


def net_from_numpy(obj, device=None) -> dict:
    """The motion net's nested dict ({timenet: {w0, ...}, heads: {...}})."""
    dev = resolve_device(device)
    return {k: net_from_numpy(v, dev) if isinstance(v, Mapping)
            else _tensor(v, dev) for k, v in obj.items()}


def net_to_numpy(net: dict) -> dict:
    return {k: net_to_numpy(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in net.items()}


def dyn_params_from_numpy(obj, device=None) -> DynParams:
    """DynParams from `{gauss: {xyz, ...}, motion_coeff, net}`."""
    dev = resolve_device(device)
    f = _fields(obj)
    return DynParams(gauss=_tuple_from(GaussianParams, f["gauss"], dev),
                     motion_coeff=_tensor(f["motion_coeff"], dev),
                     net=net_from_numpy(f["net"], dev))


def dyn_params_to_numpy(params: DynParams) -> dict:
    return {"gauss": _tuple_to(params.gauss),
            "motion_coeff": _to_numpy(params.motion_coeff),
            "net": net_to_numpy(params.net)}


def dyn_state_from_numpy(obj, device=None) -> DynTrainState:
    """DynTrainState from `{store, motion_coeff, net, opt: {mu, nu, count},
    stats}`, the moments shaped like DynParams."""
    dev = resolve_device(device)
    f = _fields(obj)
    opt = _fields(f["opt"])
    return DynTrainState(
        store=store_from_numpy(f["store"], dev),
        motion_coeff=_tensor(f["motion_coeff"], dev),
        net=net_from_numpy(f["net"], dev),
        opt=AdamState(mu=dyn_params_from_numpy(opt["mu"], dev),
                      nu=dyn_params_from_numpy(opt["nu"], dev),
                      count=_tensor(opt["count"], dev).to(torch.int32)),
        stats=stats_from_numpy(f["stats"], dev))


def dyn_state_to_numpy(state: DynTrainState) -> dict:
    return {"store": store_to_numpy(state.store),
            "motion_coeff": _to_numpy(state.motion_coeff),
            "net": net_to_numpy(state.net),
            "opt": {"mu": dyn_params_to_numpy(state.opt.mu),
                    "nu": dyn_params_to_numpy(state.opt.nu),
                    "count": _to_numpy(state.opt.count)},
            "stats": stats_to_numpy(state.stats)}
