"""Functional Adam over trees of tensors, and the camera pose optimizer's
state and learning rates. Port of `rodygs_tpu/train/optim.py` (`AdamState`,
`adam_init`, `adam_update`, `sparse_row_adam_init`,
`sparse_row_adam_update`, `CameraPoses`, `camera_lr_tree`).

A tree is a tensor, a NamedTuple or a dict of trees: `GaussianParams`,
`CameraPoses`, and the dynamic model's nested `DynParams` (Gaussian params,
motion coefficients and the motion net's dict). A learning-rate tree has the
params' structure with numbers or 0-dim tensors as its leaves, or is one
number for all.

Bias correction and eps placement follow torch.optim.Adam (eps 1e-15 as
the reference sets it). The update is functional, like the JAX one: it
returns new parameter and moment tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..utils.profiling import host_read


class AdamState(NamedTuple):
    mu: Any              # first moments (same NamedTuple type as params)
    nu: Any              # second moments
    count: torch.Tensor  # [] int32 step counter ([F] for the row-sparse Adam)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching nodes of `rest`, which
    share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [tree_map(fn, *nodes) for nodes in zip(tree, *rest)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def adam_init(params: Any) -> AdamState:
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


@torch.no_grad()
def adam_update(grads: Any, state: AdamState, params: Any, lr: Any,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15,
                update_gate=None) -> tuple[Any, AdamState]:
    """One Adam step. `lr` is a scalar or a tree of scalars matching
    `params`. `update_gate` (0/1): when 0 the step is a full no-op —
    params, moments and count all stay frozen."""
    count = state.count + 1
    t = count.to(torch.float32)
    with host_read():
        b1_t = torch.tensor(b1, dtype=torch.float32, device=t.device)
    with host_read():
        b2_t = torch.tensor(b2, dtype=torch.float32, device=t.device)
    c1 = 1.0 - torch.pow(b1_t, t)
    c2 = 1.0 - torch.pow(b2_t, t)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    if not isinstance(lr, (tuple, dict)):
        lr = tree_map(lambda _, x=lr: x, params)

    def step(p, m, v, lr_p):
        return p - lr_p * (m / c1) / (torch.sqrt(v / c2) + eps)

    new_params = tree_map(step, params, mu, nu, lr)
    if update_gate is not None:
        keep = torch.as_tensor(update_gate, dtype=torch.float32) > 0.0

        def sel(new, old):
            return torch.where(keep.to(new.device), new, old)

        new_params = tree_map(sel, new_params, params)
        mu = tree_map(sel, mu, state.mu)
        nu = tree_map(sel, nu, state.nu)
        count = sel(count, state.count)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


def sparse_row_adam_init(params: Any, n_rows: int) -> AdamState:
    """State of `sparse_row_adam_update`: zero moments and a [n_rows] int32
    step count."""
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((n_rows,), dtype=torch.int32,
                                       device=tree_leaves(params)[0].device))


@torch.no_grad()
def sparse_row_adam_update(grads: Any, state: AdamState, params: Any, lr: Any,
                           row_mask: torch.Tensor, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-15
                           ) -> tuple[Any, AdamState]:
    """Adam over a stack of per-row parameters ([F, ...] leaves) where only
    the `row_mask` rows received gradients this step: the moments, step
    counts and parameters of the other rows stay frozen instead of decaying.

    The camera poses of all F frames share one Adam and train one frame per
    iteration; with the rows masked, round-robin sampling is exactly an
    independent Adam per camera (no reference counterpart; the JAX package's
    `camera_sparse_adam`). `state.count` is [F] int32
    (`sparse_row_adam_init`)."""
    mask = row_mask.to(torch.bool)
    count = state.count + mask.to(torch.int32)               # [F]
    t = count.to(torch.float32)
    with host_read():
        b1_t = torch.tensor(b1, dtype=torch.float32, device=t.device)
    with host_read():
        b2_t = torch.tensor(b2, dtype=torch.float32, device=t.device)
    c1 = 1.0 - torch.pow(b1_t, t)
    c2 = 1.0 - torch.pow(b2_t, t)

    def rows(x, like):   # [F] against [F, D...]
        return x.reshape(x.shape + (1,) * (like.dim() - 1))

    mu = tree_map(lambda m, g: torch.where(rows(mask, m),
                                           b1 * m + (1 - b1) * g, m),
                  state.mu, grads)
    nu = tree_map(lambda v, g: torch.where(rows(mask, v),
                                           b2 * v + (1 - b2) * g * g, v),
                  state.nu, grads)
    if not isinstance(lr, (tuple, dict)):
        lr = tree_map(lambda _, x=lr: x, params)

    def step(p, m, v, lr_p):
        # unvisited rows have c1 == 0; the where() discards their lanes
        upd = p - lr_p * (m / torch.clamp(rows(c1, p), min=1e-30)) / (
            torch.sqrt(v / torch.clamp(rows(c2, p), min=1e-30)) + eps)
        return torch.where(rows(mask, p), upd, p)

    new_params = tree_map(step, params, mu, nu, lr)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


class CameraPoses(NamedTuple):
    """Dataset-level learnable poses: q_c2w [F, 4], t_c2w [F, 3]."""

    q_c2w: torch.Tensor
    t_c2w: torch.Tensor


def camera_lr_tree(step, rotation_lr: float, translation_lr: float,
                   warmup: int, total_steps: int) -> CameraPoses:
    """Per-leaf learning rates of the camera Adam at a step."""
    from ..ops.schedules import warmup_cosine_lr

    return CameraPoses(
        q_c2w=warmup_cosine_lr(step, rotation_lr, warmup, total_steps),
        t_c2w=warmup_cosine_lr(step, translation_lr, warmup, total_steps),
    )
