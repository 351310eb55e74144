"""Device mesh over the process world. Port of `rodygs_tpu/parallel/mesh.py`
on `torch.distributed`.

One process (rank) per mesh position. The axes are the JAX package's:
  * "data"  — each data row renders a different frame of the stacked
    batch; gradients are averaged over the row (`pmean`).
  * "gauss" — the Gaussian store, its Adam moments and statistics are
    split by capacity block; projected records are all-gathered per
    render and the gather's backward (a reduce-scatter) hands each block
    its own gradients.
  * "tile"  — each rank composites one contiguous block of the tile grid;
    the planes are all-gathered.

Ranks are laid out as the JAX package reshapes its devices, data
outermost: rank = (d * n_gauss + g) * n_tile + t. The composite axis
("gauss", "tile") indexes its ranks as g * n_tile + t, as JAX's
`axis_index` over a tuple of axes does.

Every process group is created on every rank in the same order (a torch
requirement); an axis of size 1 has no group and its collectives are the
identity.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import socket

import torch
import torch.distributed as dist

AXES = ("data", "gauss", "tile")
# the environment variable the CLIs read the backend from (multihost.py)
BACKEND_ENV = "RODYGS_DIST_BACKEND"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis, or several taken together, as this rank sees it:
    its size, this rank's index along it, the process group of this rank's
    line along it (None when the size is 1) and this rank's device, which
    the collectives check tensors against."""

    names: tuple[str, ...]
    size: int
    index: int
    group: object | None
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("data", "gauss", "tile") mesh: `shape` with the JAX package's
    keys, this rank's `coords`, its `device` and the `axes` it holds a
    group for (each axis and the composite ("gauss", "tile"))."""

    shape: dict
    coords: dict
    rank: int
    world_size: int
    backend: str
    device: torch.device
    axes: dict

    def axis(self, names) -> Axis:
        """The Axis of a name or a tuple of names (in mesh order)."""
        key = (names,) if isinstance(names, str) else tuple(names)
        if key not in self.axes:
            raise KeyError(f"mesh has no axis {names!r}")
        return self.axes[key]

    @property
    def world(self) -> Axis:
        return self.axes[AXES]


def rank_of(coords: dict, shape: dict) -> int:
    return ((coords["data"] * shape["gauss"] + coords["gauss"])
            * shape["tile"] + coords["tile"])


def coords_of(rank: int, shape: dict) -> dict:
    return {"data": rank // (shape["gauss"] * shape["tile"]),
            "gauss": (rank // shape["tile"]) % shape["gauss"],
            "tile": rank % shape["tile"]}


def rank_device(device=None) -> torch.device:
    """This rank's device: `cuda:(LOCAL_RANK % device_count)` by default
    (LOCAL_RANK as torchrun sets it, else the global rank), or the device
    the caller asks for."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "rodygs_tpu_torch.parallel: CUDA is not available; pass "
            "device='cpu' to run the mesh on the CPU explicitly")
    local = int(os.environ.get(
        "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _check_nccl_cards(device: torch.device) -> None:
    """NCCL refuses two ranks on one card: say so before any NCCL
    communicator is made (over a Gloo helper group)."""
    helper = dist.new_group(backend="gloo")
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (socket.gethostname(), device.index),
                           group=helper)
    dist.destroy_process_group(helper)
    if len(set(seen)) < len(seen):
        raise ValueError(
            f"NCCL needs one card per rank; ranks share cards {seen}. Run "
            f"ranks that share a card with the gloo backend "
            f"({BACKEND_ENV}=gloo, or backend='gloo').")


def make_mesh(n_data: int | None = None, n_tile: int = 1, n_gauss: int = 1,
              device=None) -> Mesh:
    """Build the ("data", "gauss", "tile") mesh over the process world
    (a world of one process when torch.distributed is not initialized).
    `n_data` defaults to the world size over n_tile * n_gauss; a product
    that does not match the world size raises."""
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        n_data = world // (n_tile * n_gauss)
    if n_data * n_tile * n_gauss != world:
        raise ValueError(f"mesh {n_data}x{n_gauss}x{n_tile} != {world} "
                         "processes")
    shape = {"data": n_data, "gauss": n_gauss, "tile": n_tile}
    coords = coords_of(rank, shape)
    dev = rank_device(device)
    backend = dist.get_backend() if initialized else "none"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device")
        _check_nccl_cards(dev)

    axes = {}
    for names in (("data",), ("gauss",), ("tile",), ("gauss", "tile"), AXES):
        size = 1
        for a in names:
            size *= shape[a]
        index = 0
        for a in names:
            index = index * shape[a] + coords[a]
        group = None
        if size > 1:
            # one group per line along `names`; all created on every rank
            others = [a for a in AXES if a not in names]
            for fixed in itertools.product(*[range(shape[a]) for a in others]):
                members = []
                for along in itertools.product(
                        *[range(shape[a]) for a in names]):
                    c = dict(zip(others, fixed)) | dict(zip(names, along))
                    members.append(rank_of(c, shape))
                g = (dist.new_group(members) if names != AXES
                     else dist.group.WORLD)
                if rank in members:
                    group = g
        axes[names] = Axis(names, size, index, group, dev)
    return Mesh(shape, coords, rank, world, backend, dev, axes)
