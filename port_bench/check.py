"""The comparison that decides `correct` for a training cell: the program's
iterations of a followed stretch against the reference's from the same
state.

Three numbers a stretch, each with its limit from the cell's file:

  loss_gap    the largest |program - reference| / |reference| of the static
              and the dynamic loss over the followed iterations
  grad_gap    the worst leaf's |‖g_program‖ - ‖g_reference‖| / max(‖g_reference‖,
              the median leaf's ‖g_reference‖), g the first iteration's
              gradient as each Adam holds it
              ((first moment after - beta1 first moment before) / (1 - beta1))
  change_gap  the same over each leaf's change ‖after - before‖ across the
              stretch, the densification statistics included; leaves whose
              reference gradient is under a thousandth of the median leaf's
              move by round-off alone and are left out

Norms are taken in float64 on the host. `correct` holds every number
compared (these and any count the traffic adds) to its limit.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3
STATS_PREFIXES = ("static_stats.", "dynamic_stats.")


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def _worst(prog: dict, ref: dict, names) -> tuple[float, str]:
    med = statistics.median(ref[n] for n in names)
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if not gap <= worst:
            worst, at = gap, n
    return worst, at


def gaps(prog, ref, initial: dict) -> dict:
    """{"loss_gap": (value, where), "grad_gap": ..., "change_gap": ...} of
    two sides' `Follow`s (losses, first gradients, leaves after the last
    iteration) of one stretch. `initial` holds the leaves before it; a
    statistic missing there starts at zero."""
    loss, at = 0.0, ""
    for k, (pair_p, pair_r) in enumerate(zip(prog.losses, ref.losses)):
        for name, lp, lr in zip(("static", "dynamic"), pair_p, pair_r):
            gap = abs(lp - lr) / max(abs(lr), 1e-30)
            if not gap <= loss:
                loss, at = gap, f"{name} loss, iteration {k + 1}"
    g_ref = {n: _norm(v) for n, v in ref.first_grads.items()}
    g_prog = {n: _norm(prog.first_grads[n]) for n in ref.first_grads}
    grad = _worst(g_prog, g_ref, list(ref.first_grads))
    med_g = statistics.median(g_ref.values())
    moved = [n for n in ref.params if n.startswith(STATS_PREFIXES)
             or g_ref[n] >= NEGLIGIBLE_GRAD * med_g]

    def change(leaves):
        return {n: _norm(leaves[n] - initial[n]) if n in initial
                else _norm(leaves[n]) for n in moved}

    return {"loss_gap": (loss, at), "grad_gap": grad,
            "change_gap": _worst(change(prog.params), change(ref.params),
                                 moved)}


def correct(found: dict, limits: dict) -> bool:
    """Every number found ({name: value}) is at or under its limit, and
    every limit has its number."""
    return set(found) == set(limits) and all(
        found[k] <= limits[k] for k in limits)
