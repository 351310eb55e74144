"""Multi-device train steps and densification. Port of
`rodygs_tpu/parallel/sharded.py` (`stack_batches`, `composite_axes`,
`make_sharded_static_step`, `make_sharded_densify`,
`make_sharded_dynamic_densify`, `make_sharded_dynamic_step`) on
`torch.distributed`: every rank runs the JAX `device_fn` on its own mesh
position and the collectives of parallel/collectives.py stand in for the
`lax` ones.

  * "data": each data row renders a different frame of the stacked batch
    (row `coords["data"]`); the step optimises the mean frame loss, so the
    gradients are averaged over the row. The densification statistics
    combine over the frames: grad_accum / denom by sum, max_radii2d by
    max; overflow, dropped and num_fragments by max.
  * "gauss": each rank holds only its own capacity block of the static
    store, its Adam moments and statistics; the global array is the blocks
    concatenated in gauss order, the JAX package's global layout. Only
    projected records move (render(gauss_axis=)).
  * "tile": compositing splits over the composite ("gauss", "tile") axis
    (`composite_axes`), each rank one block of the tile grid.

Exact gradients: every rank of the composite block computes the same
full-image loss on the gathered planes, and the planes' gather sums their
n_comp identical cotangents in its backward, so the differentiated loss is
scaled by 1/n_comp; the psums below then give the exact gradients. The
densification statistic is a nonlinear norm of the screen gradient, taken
only after that reassembly. The tile columns already hold identical
statistics (the JAX package psums them and divides by n_tile to keep one
copy; here every rank keeps its own copy, so that step has nothing to do).

Each step is a gradient function (`grads`, the JAX `device_fn`, where all
collectives happen) and an `update` on this rank's state, so the checks
can hold the gradients themselves. Every rank must take the same host
decisions (profile, SH degree, densification iterations, resume): the
fragment counts the poller reads are reduced over the data axis, and a
composite block bins one gathered set, so they agree on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import gaussians as G
from ..train.densify import DensifyStats, accumulate_stats, init_stats
from ..train.optim import CameraPoses, tree_map
from ..train.trainer_static import (FrameBatch, StaticTrainState,
                                    apply_static_update,
                                    static_loss_and_grads)
from .collectives import all_gather_rows, pmax, psum
from .mesh import Axis, Mesh


def stack_batches(batches: list[FrameBatch]) -> FrameBatch:
    """Per-frame batches stacked into [B, ...] tensors (None fields must be
    None in all); `frame_idx` becomes the tuple of the B frame indices."""
    def stack(name):
        xs = [getattr(b, name) for b in batches]
        return None if xs[0] is None else torch.stack(xs)

    return FrameBatch(
        gt_image=stack("gt_image"), gt_depth=stack("gt_depth"),
        motion_mask=stack("motion_mask"),
        frame_idx=tuple(int(b.frame_idx) for b in batches),
        time=stack("time"), fovx=stack("fovx"), fovy=stack("fovy"))


def batch_row(batch: FrameBatch, row: int) -> FrameBatch:
    """Row `row` of a stacked batch, as one frame's FrameBatch."""
    return FrameBatch(*[None if x is None else x[row]
                        for x in batch[:3]], batch.frame_idx[row],
                      batch.time[row], batch.fovx[row], batch.fovy[row])


def composite_axes(mesh: Mesh) -> Axis | None:
    """The axis over which the tile grid splits: the gauss axis would
    otherwise replicate the compositing work, so it joins the tile split."""
    names = tuple(a for a in ("gauss", "tile") if mesh.shape[a] > 1)
    return mesh.axis(names) if names else None


def fold_in_seed(seed: int, index: int) -> int:
    """A seed for shard `index` of a generator seeded with `seed` (the
    counterpart of folding the shard index into a JAX key)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


# --------------------------------------------------------------------------
# gauss blocks
# --------------------------------------------------------------------------


def _block(x: torch.Tensor, index: int, size: int) -> torch.Tensor:
    rows = x.shape[0] // size
    return x[index * rows:(index + 1) * rows]


def _static_rows(state: StaticTrainState):
    """The per-Gaussian trees of a static state (split by gauss block)."""
    return (state.store, state.opt.mu, state.opt.nu, state.stats)


def _with_static_rows(state: StaticTrainState, rows) -> StaticTrainState:
    store, mu, nu, stats = rows
    return state._replace(store=store, stats=stats,
                          opt=state.opt._replace(mu=mu, nu=nu))


def static_state_block(state: StaticTrainState, mesh: Mesh):
    """This rank's gauss block of a global static state."""
    g, n = mesh.coords["gauss"], mesh.shape["gauss"]
    return _with_static_rows(state, tree_map(lambda x: _block(x, g, n),
                                             _static_rows(state)))


def static_state_global(state: StaticTrainState, mesh: Mesh):
    """The global static state from every rank's block (a collective)."""
    return _with_static_rows(state, all_gather_rows(
        _static_rows(state), mesh.axis("gauss")))


def _dyn_rows(state):
    mu, nu = state.opt.mu, state.opt.nu
    return (state.store, state.motion_coeff, mu.gauss, mu.motion_coeff,
            nu.gauss, nu.motion_coeff, state.stats)


def _with_dyn_rows(state, rows):
    store, coeff, mu_g, mu_c, nu_g, nu_c, stats = rows
    opt = state.opt._replace(
        mu=state.opt.mu._replace(gauss=mu_g, motion_coeff=mu_c),
        nu=state.opt.nu._replace(gauss=nu_g, motion_coeff=nu_c))
    return state._replace(store=store, motion_coeff=coeff, opt=opt,
                          stats=stats)


# --------------------------------------------------------------------------
# static step
# --------------------------------------------------------------------------


def _fragments(out, data: Axis):
    """(overflow, dropped, num_fragments) of the worst frame of the data
    row (binning is identical across a composite block)."""
    frag = torch.stack([out["overflow"].to(torch.int32),
                        out["dropped"].to(torch.int32),
                        out["num_fragments"].to(torch.int32)])
    frag = pmax(frag, data)
    return frag[0] > 0, frag[1], frag[2]


class ShardedStaticStep:
    """The multi-device static step (`make_sharded_static_step`).

    `step(state, batch, iteration, active, sh_degree, fragment_profile)`
    takes this rank's gauss block of the state and the stacked batch (B =
    the data axis size) and returns (new_state, metrics); `grads` and
    `update` are its two halves. `gen` draws the loss's samples and must
    be in the same state on every rank."""

    def __init__(self, cfg, loss, mesh: Mesh, spatial_lr_scale: float,
                 gen: torch.Generator):
        self.cfg, self.loss, self.mesh, self.gen = cfg, loss, mesh, gen
        self.spatial_lr_scale = float(spatial_lr_scale)
        self.data = mesh.axis("data")
        self.tile = mesh.axis("tile")
        self.gauss = mesh.axis("gauss") if mesh.shape["gauss"] > 1 else None
        self.comp = composite_axes(mesh)
        self.inv_comp = 1.0 / (mesh.shape["gauss"] * mesh.shape["tile"])

    def grads(self, state: StaticTrainState, batch: FrameBatch, active,
              sh_degree: int, fragment_profile="lean"):
        """The JAX `device_fn`: (total, g_params, g_poses, stat_delta,
        overflow, dropped, num_fragments), gradients averaged over the data
        row, stat_delta for this rank's block."""
        mesh = self.mesh
        total, aux, (g_params, g_poses, g_offset) = static_loss_and_grads(
            self.cfg, self.loss, self.gen, state,
            batch_row(batch, mesh.coords["data"]), active, sh_degree,
            fragment_profile, tile_axis=self.comp, gauss_axis=self.gauss,
            loss_scale=self.inv_comp)
        # radii / visibility cover the gathered set: take this block's
        n_local = G.capacity_of(state.store)
        start = mesh.coords["gauss"] * n_local
        radii = aux["radii"][start:start + n_local]
        visible = aux["visible"][start:start + n_local]
        overflow, dropped, num_fragments = _fragments(aux, self.data)
        # each tile column saw only its tiles' cotangents (the gauss part
        # of the split was summed by the record gather's reduce-scatter);
        # pose gradients sum over every Gaussian, so over the whole block
        g_params, g_offset = psum((g_params, g_offset), self.tile)
        if self.comp is not None:
            g_poses = psum(g_poses, self.comp)
        # this frame's exact screen gradient: the statistics before frame
        # averaging (every frame's norm accumulates)
        new = accumulate_stats(state.stats, g_offset,
                               radii.to(torch.float32), visible)
        new_max = pmax(new.max_radii2d, self.data)
        n_data = self.data.size
        g_params, g_poses, total, d_accum, d_denom = psum(
            (g_params, g_poses, total,
             new.grad_accum - state.stats.grad_accum,
             new.denom - state.stats.denom), self.data)
        g_params = tree_map(lambda g: g / n_data, g_params)
        g_poses = tree_map(lambda g: g / n_data, g_poses)
        stat_delta = DensifyStats(grad_accum=d_accum, denom=d_denom,
                                  max_radii2d=new_max - state.stats.max_radii2d)
        return (total / n_data, g_params, g_poses, stat_delta, overflow,
                dropped, num_fragments)

    def update(self, state: StaticTrainState, grads, iteration,
               frame_idx) -> StaticTrainState:
        """The trainer's update on this rank's block and the (replicated)
        poses; the sparse camera Adam steps the union of the batch's
        frames."""
        _, g_params, g_poses, stat_delta = grads[:4]
        new_stats = tree_map(lambda s, d: s + d, state.stats, stat_delta)
        return apply_static_update(self.cfg, self.spatial_lr_scale, state,
                                   g_params, g_poses, new_stats, iteration,
                                   frame_idx)

    def __call__(self, state, batch, iteration, active, sh_degree: int,
                 fragment_profile="lean"):
        grads = self.grads(state, batch, active, sh_degree, fragment_profile)
        new_state = self.update(state, grads, iteration, batch.frame_idx)
        total, overflow, dropped, num_fragments = (grads[0], *grads[4:])
        return new_state, {"loss": total, "overflow": overflow,
                           "dropped": dropped, "num_fragments": num_fragments}


def make_sharded_static_step(cfg, loss, mesh: Mesh, spatial_lr_scale: float,
                             gen: torch.Generator) -> ShardedStaticStep:
    return ShardedStaticStep(cfg, loss, mesh, spatial_lr_scale, gen)


# --------------------------------------------------------------------------
# densification
# --------------------------------------------------------------------------


def make_sharded_densify(local_densify, mesh: Mesh):
    """Sharded static densification: `local_densify(state,
    max_screen_size) -> (state, info)` clones / splits / prunes inside
    this rank's capacity block (its generator seeded per gauss shard, see
    `fold_in_seed`), and the DensifyInfo is summed over the gauss axis.
    Blocks fill independently: a full block drops its own overflow, which
    the summed `dropped` shows; `G.shard_interleave` at init balances the
    alive slots."""
    gauss = mesh.axis("gauss")

    def densify(state, max_screen_size):
        state, info = local_densify(state, max_screen_size)
        return state, psum(info, gauss)

    return densify


def make_sharded_dynamic_densify(local_densify, mesh: Mesh):
    """Sharded dynamic densification: the replicated dynamic state (store,
    motion coefficients, their moments, statistics) is densified per shard
    on the rank's slice [d0, d0 + cd_loc) by `local_densify`, then
    all-gathered over the gauss axis so every rank holds it whole again
    (the resharding JAX does implicitly). The net and its moments are
    row-free and pass through."""
    gauss = mesh.axis("gauss")

    def densify(state, max_screen_size):
        cd = G.capacity_of(state.store)
        if cd % gauss.size:
            raise ValueError(f"dynamic capacity {cd} does not split into "
                             f"{gauss.size} gauss shards")
        rows = tree_map(lambda x: _block(x, gauss.index, gauss.size),
                        _dyn_rows(state))
        local, info = local_densify(_with_dyn_rows(state, rows),
                                    max_screen_size)
        full = all_gather_rows(_dyn_rows(local), gauss)
        return _with_dyn_rows(local, full), psum(info, gauss)

    return densify


# --------------------------------------------------------------------------
# dynamic step
# --------------------------------------------------------------------------


class ShardedDynamicStep:
    """The multi-device dynamic step (`make_sharded_dynamic_step`).

    The static store enters as this rank's gauss block; the dynamic store
    is replicated and this rank composites [its static block | its slice of
    the deformed dynamic store]. The dynamic gradients are summed over the
    composite block and averaged over the data row; the dynamic rows'
    screen gradients are scattered into the full layout before the
    statistics are taken. `step(dyn_state, static_store, poses, batch,
    iteration, active, sh_degree, use_deform, fragment_profile)` returns
    (new_dyn_state, metrics); the loss, render and update are the dynamic
    trainer's (`DynTrainer.loss_and_grads` / `apply_update`)."""

    def __init__(self, dyn_trainer, mesh: Mesh):
        self.dyn, self.mesh = dyn_trainer, mesh
        self.data = mesh.axis("data")
        self.gauss = mesh.axis("gauss") if mesh.shape["gauss"] > 1 else None
        self.comp = composite_axes(mesh)
        self.inv_comp = 1.0 / (mesh.shape["gauss"] * mesh.shape["tile"])

    def grads(self, dyn_state, static_store: G.GaussianStore,
              poses: CameraPoses, batch: FrameBatch, active, sh_degree: int,
              use_deform: bool, fragment_profile="lean"):
        """(total, g_params, stat_delta, overflow, dropped, num_fragments):
        the dynamic gradients whole on every rank, stat_delta over the full
        dynamic store."""
        mesh = self.mesh
        n_gauss, g = mesh.shape["gauss"], mesh.coords["gauss"]
        cd = G.capacity_of(dyn_state.store)
        if cd % n_gauss:
            raise ValueError(f"dynamic capacity {cd} not divisible by gauss "
                             f"axis {n_gauss}")
        cd_loc = cd // n_gauss
        d0 = g * cd_loc
        cs_loc = G.capacity_of(static_store)
        total, aux, (g_params, g_offset) = self.dyn.loss_and_grads(
            dyn_state, static_store, poses,
            batch_row(batch, mesh.coords["data"]), active, sh_degree,
            use_deform, fragment_profile, dyn_rows=slice(d0, d0 + cd_loc),
            tile_axis=self.comp, gauss_axis=self.gauss,
            loss_scale=self.inv_comp)
        # radii / visibility cover the gathered [static | dynamic] blocks:
        # the dynamic rows, slice order = store order
        blk = cs_loc + cd_loc
        radii = aux["radii"].reshape(n_gauss, blk)[:, cs_loc:].reshape(cd)
        visible = aux["visible"].reshape(n_gauss, blk)[:, cs_loc:].reshape(cd)
        overflow, dropped, num_fragments = _fragments(aux, self.data)
        # the image-path gradients of the dynamic params lie in this rank's
        # rows, the regularisers' are whole but 1/n_comp-scaled: one psum
        # over the composite block reassembles both; the screen gradient of
        # this rank's dynamic slice goes into the full layout first
        g_off_dyn = torch.zeros((2, cd), device=g_offset.device)
        g_off_dyn[:, d0:d0 + cd_loc] = g_offset[:, cs_loc:]
        if self.comp is not None:
            g_params, g_off_dyn = psum((g_params, g_off_dyn), self.comp)
        frame = accumulate_stats(init_stats(cd, device=g_offset.device),
                                 g_off_dyn, radii.to(torch.float32), visible)
        n_data = self.data.size
        g_params, total, d_accum, d_denom = psum(
            (g_params, total, frame.grad_accum, frame.denom), self.data)
        g_params = tree_map(lambda x: x / n_data, g_params)
        stat_delta = DensifyStats(
            grad_accum=d_accum, denom=d_denom,
            max_radii2d=pmax(frame.max_radii2d, self.data))
        return (total / n_data, g_params, stat_delta, overflow, dropped,
                num_fragments)

    def update(self, dyn_state, grads, iteration):
        """The trainer's update, the statistics combined with the step's."""
        _, g_params, stat_delta = grads[:3]
        old = dyn_state.stats
        new_stats = DensifyStats(
            grad_accum=old.grad_accum + stat_delta.grad_accum,
            denom=old.denom + stat_delta.denom,
            max_radii2d=torch.maximum(old.max_radii2d, stat_delta.max_radii2d))
        return self.dyn.apply_update(dyn_state, g_params, new_stats,
                                     iteration)

    def __call__(self, dyn_state, static_store, poses, batch, iteration,
                 active, sh_degree: int, use_deform: bool,
                 fragment_profile="lean"):
        grads = self.grads(dyn_state, static_store, poses, batch, active,
                           sh_degree, use_deform, fragment_profile)
        new_state = self.update(dyn_state, grads, iteration)
        total, overflow, dropped, num_fragments = (grads[0], *grads[3:])
        return new_state, {"loss": total, "overflow": overflow,
                           "dropped": dropped, "num_fragments": num_fragments}


def make_sharded_dynamic_step(dyn_trainer, mesh: Mesh) -> ShardedDynamicStep:
    return ShardedDynamicStep(dyn_trainer, mesh)

