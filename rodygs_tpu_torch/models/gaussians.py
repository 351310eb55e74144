"""Gaussian store: fixed-capacity NamedTuples of tensors with an alive mask.
Port of `rodygs_tpu/models/gaussians.py` (fields, activations,
`from_point_cloud`, `capacity_of`, `num_alive`, `unique_times`,
`active_arrays`, `sh_degree_up`, `to_state_dict` / `from_state_dict`,
`shard_interleave`).

Raw (pre-activation) parameters keep the JAX field names and layouts so
state converts one-to-one (convert.py). Dead capacity slots carry zeroed
parameters; the renderer masks them through `alive`.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops.knn import mean_knn_sqdist
from ..ops.quaternion import quat_normalize
from ..ops.sh import num_sh_coeffs, rgb2sh
from ..utils.platform import resolve_device


class GaussianParams(NamedTuple):
    """Raw (pre-activation) parameters, leading dim = capacity."""

    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, K-1, 3]
    scaling: torch.Tensor        # [C, 3] log-scale ([C, 1] if isotropic)
    rotation: torch.Tensor       # [C, 4] quaternion (w,x,y,z)
    opacity: torch.Tensor        # [C, 1] logit


class GaussianStore(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor          # [C] bool
    time: torch.Tensor           # [C] per-Gaussian birth timestamp
    time_ind: torch.Tensor       # [C] int32 index into unique timesteps


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def shard_interleave(store: GaussianStore, n_shards: int) -> GaussianStore:
    """Permute capacity slots so the alive Gaussians (packed at the front by
    `from_point_cloud`) spread round-robin over `n_shards` equal blocks:
    done once before the store is split over a "gauss" mesh axis, so every
    shard starts with ~n/S alive slots and equal densification headroom.
    Slot order is otherwise free (it only breaks depth-sort ties)."""
    c = capacity_of(store)
    if c % n_shards:
        raise ValueError(f"capacity {c} does not split into {n_shards} shards")
    src = torch.as_tensor(
        np.arange(c).reshape(c // n_shards, n_shards).T.reshape(-1),
        device=store.alive.device)
    params = type(store.params)(*[x[src] for x in store.params])
    return GaussianStore(params=params, alive=store.alive[src],
                         time=store.time[src], time_ind=store.time_ind[src])


def capacity_of(store: GaussianStore) -> int:
    return store.params.xyz.shape[0]


def num_alive(store: GaussianStore) -> torch.Tensor:
    return torch.sum(store.alive.to(torch.int32))


def get_scaling(params: GaussianParams, isotropic: bool = False) -> torch.Tensor:
    s = torch.exp(params.scaling)
    if isotropic:
        s = s[:, :1].expand(s.shape[0], 3)
    return s


def get_rotation(params: GaussianParams) -> torch.Tensor:
    return quat_normalize(params.rotation)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity[:, 0])


def get_features(params: GaussianParams) -> torch.Tensor:
    """[C, K, 3] full SH coefficient stack."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def round_capacity(n: int, multiple: int = 256) -> int:
    return -(-n // multiple) * multiple


def from_point_cloud(
    points: np.ndarray,
    colors: np.ndarray,
    sh_degree: int,
    capacity: int | None = None,
    times: np.ndarray | None = None,
    isotropic: bool = False,
    capacity_factor: float = 4.0,
    device: str | torch.device | None = None,
) -> GaussianStore:
    """Initialize from a point cloud: DC SH from RGB2SH(color), higher bands
    zero, log-scale from sqrt(mean 3-NN squared distance), identity
    rotations, opacity sigmoid^-1(0.1), capacity = capacity_factor * N."""
    dev = resolve_device(device)
    n = points.shape[0]
    if capacity is None:
        capacity = round_capacity(int(n * capacity_factor))
    if capacity < n:
        raise ValueError(f"capacity {capacity} < number of points {n}")
    k = num_sh_coeffs(sh_degree)

    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp(mean_knn_sqdist(pts, k=3), min=1e-7)
    log_scale = 0.5 * torch.log(dist2)
    pad = capacity - n

    def padded(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)

    cols = torch.tensor(np.asarray(colors, np.float32), device=dev)
    scaling_cols = 1 if isotropic else 3
    params = GaussianParams(
        xyz=padded(pts),
        features_dc=padded(rgb2sh(cols)[:, None, :]),
        features_rest=torch.zeros((capacity, k - 1, 3), device=dev),
        scaling=padded(log_scale[:, None].repeat(1, scaling_cols)),
        rotation=padded(torch.tensor([[1.0, 0.0, 0.0, 0.0]],
                                     device=dev).repeat(n, 1)),
        opacity=padded(torch.full(
            (n, 1), float(inverse_sigmoid(torch.tensor(0.1))), device=dev)),
    )
    alive = torch.arange(capacity, device=dev) < n
    t = (np.ones(n, np.float32) if times is None
         else np.asarray(times, np.float32).reshape(-1))
    keys = np.trunc(t * 1000).astype(np.int64)
    lut = {v: i for i, v in enumerate(np.sort(np.unique(keys)))}
    tind = np.array([lut[v] for v in keys], np.int32)
    return GaussianStore(
        params=params,
        alive=alive,
        time=padded(torch.tensor(t, device=dev)),
        time_ind=padded(torch.tensor(tind, device=dev)),
    )


def active_arrays(store: GaussianStore, isotropic: bool = False):
    """Activated tensors for the renderer: (xyz, shs, opacity, scaling,
    rotation, alive)."""
    p = store.params
    return (p.xyz, get_features(p), get_opacity(p),
            get_scaling(p, isotropic), p.rotation, store.alive)


def sh_degree_up(active_degree: int, max_degree: int) -> int:
    """`oneupSHdegree`: host-side static ramp."""
    return min(active_degree + 1, max_degree)


def unique_times(store: GaussianStore) -> np.ndarray:
    """Sorted unique birth timestamps of alive Gaussians (host-side)."""
    alive = store.alive.cpu().numpy()
    return np.sort(np.unique(store.time.cpu().numpy()[alive]))


def to_state_dict(store: GaussianStore) -> dict[str, Any]:
    """The reference checkpoint's field names for the model section."""
    p = store.params
    return {
        "_xyz": p.xyz,
        "_features_dc": p.features_dc,
        "_features_rest": p.features_rest,
        "_scaling": p.scaling,
        "_rotation": p.rotation,
        "_opacity": p.opacity,
        "alive": store.alive,
        "time": store.time,
        "time_ind": store.time_ind,
    }


def from_state_dict(sd: dict[str, Any], device=None) -> GaussianStore:
    """Inverse of `to_state_dict`; values may be tensors or numpy arrays.
    Missing `alive` / `time` / `time_ind` default to all alive, time 1 and
    index 0."""
    dev = resolve_device(device)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype, device=dev)

    params = GaussianParams(*[t(sd["_" + name]) for name in GaussianParams._fields])
    cap = params.xyz.shape[0]
    return GaussianStore(
        params=params,
        alive=t(sd.get("alive", np.ones(cap, bool)), torch.bool),
        time=t(sd.get("time", np.ones(cap, np.float32)), torch.float32),
        time_ind=t(sd.get("time_ind", np.zeros(cap, np.int32)), torch.int32))
