"""Training losses with the reference's MultiLoss semantics. Port of
`rodygs_tpu/train/losses.py` with the L1 and SSIM terms registered; the
depth, rigidity and motion terms wait for the dynamic stage (ROADMAP
queue 1 item 8).

`freq` / `start` gating is decided on the host per iteration
(`active_set`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from ..ops.image import l1_loss, ssim


def _masked_pair(pred, gt, motion_mask, mode):
    """The reference's static/dynamic mask-multiply semantics."""
    if motion_mask is None or mode in (None, "all"):
        return pred, gt
    m = motion_mask.to(pred.dtype)
    if mode == "static":
        m = 1.0 - m
    if m.ndim == pred.ndim - 1:
        m = m[..., None]
    return pred * m, gt * m


def ssim_loss(ctx, mode=None, **_):
    p, g = _masked_pair(ctx["pred_img"], ctx["gt_img"], ctx.get("motion_mask"), mode)
    return 1.0 - ssim(p, g)


def l1_loss_fn(ctx, mode=None, **_):
    p, g = _masked_pair(ctx["pred_img"], ctx["gt_img"], ctx.get("motion_mask"), mode)
    return l1_loss(p, g)


_LOSS_REGISTRY: dict[str, Callable] = {
    "SSIMLoss": ssim_loss,
    "L1Loss": l1_loss_fn,
}


@dataclasses.dataclass(frozen=True)
class LossTerm:
    name: str
    weight: float
    fn_name: str
    freq: int = 1
    start: int = 0
    params: tuple = ()  # tuple of (key, value) pairs

    def is_active(self, iteration: int) -> bool:
        return iteration % self.freq == 0 and iteration > self.start


class MultiLoss:
    """Weighted sum of sub-losses with freq/start gating."""

    def __init__(self, terms: Sequence[LossTerm]):
        for t in terms:
            if t.fn_name not in _LOSS_REGISTRY:
                raise NotImplementedError(
                    f"loss {t.fn_name!r} is not ported yet (registered: "
                    f"{sorted(_LOSS_REGISTRY)})")
        self.terms = tuple(terms)

    def active_set(self, iteration: int) -> tuple[bool, ...]:
        return tuple(t.is_active(iteration) for t in self.terms)

    @property
    def uses_normal(self) -> bool:
        """Whether any term reads ctx["pred_normal"]; no registered one does."""
        normal_losses: set[str] = set()
        return any(t.fn_name in normal_losses for t in self.terms)

    def __call__(self, ctx: dict[str, Any], active: tuple[bool, ...]):
        total = torch.zeros((), device=ctx["pred_img"].device)
        loss_dict = {}
        for term, on in zip(self.terms, active):
            if not on:
                continue
            val = _LOSS_REGISTRY[term.fn_name](ctx, **dict(term.params))
            loss_dict[term.name] = val
            total = total + term.weight * val
        return total, loss_dict
