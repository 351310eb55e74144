"""Multi-device training on torch.distributed. Port of `rodygs_tpu/parallel`:
`mesh` (the ("data", "gauss", "tile") mesh over the process world),
`collectives` (the `lax` collectives), `multihost` (bootstrap and the
shared-filesystem discipline), `sharded` (the sharded steps and
densification) and `dryrun` (a spawned world that runs the joint trainer).
Only the mesh is imported here: the render imports the collectives, and
`sharded` imports the render."""

from .mesh import Axis, Mesh, make_mesh  # noqa: F401
