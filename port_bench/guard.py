"""The run's refusal of JAX: no module whose top-level name (the part before
the first dot, compared whole) is one of these may be loaded in the process
that prints the result. `rodygs_tpu_torch` begins with `rodygs_tpu` and is
not one of them."""

from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "rodygs_tpu")


def forbidden_modules(names) -> list[str]:
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
