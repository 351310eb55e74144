"""Rank functions of the multi-device parity tests (tests/test_torch_*.py
that spawn worlds with `rodygs_tpu_torch.parallel.dryrun.run_world`).

The ranks are fresh processes: this module imports nothing of JAX or of the
JAX package. The tests compute the JAX side in their own process and pass
numpy inputs in; every function here returns numpy results (the global
ones from rank 0 only, where every rank holds the same).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from rodygs_tpu_torch import convert
from rodygs_tpu_torch.models import gaussians as G
from rodygs_tpu_torch.parallel import collectives as C
from rodygs_tpu_torch.parallel import multihost as MH
from rodygs_tpu_torch.parallel import sharded as S
from rodygs_tpu_torch.parallel.mesh import make_mesh
from rodygs_tpu_torch.render import rasterize as R
from rodygs_tpu_torch.render.camera import make_camera
from rodygs_tpu_torch.train import densify as D
from rodygs_tpu_torch.train.losses import LossTerm, MultiLoss
from rodygs_tpu_torch.train.optim import CameraPoses, tree_map
from rodygs_tpu_torch.train.trainer_dynamic import DynTrainer, DynTrainerConfig
from rodygs_tpu_torch.train.trainer_static import (
    FrameBatch, StaticTrainerConfig, StaticTrainState, ThreeDGSTrainer)


def mesh_of(shape: dict):
    return make_mesh(n_data=shape["data"], n_tile=shape["tile"],
                     n_gauss=shape["gauss"], device="cpu")


def T(x, grad=False):
    return torch.tensor(np.array(x), requires_grad=grad)


def npy(tree):
    """numpy leaves of a tree of NamedTuples / dicts / tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "_asdict"):
        return {k: npy(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: npy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [npy(v) for v in tree]
    return tree


def frames(batch_np: list) -> FrameBatch:
    """The stacked batch from a list of numpy frames."""
    return S.stack_batches([FrameBatch(
        gt_image=T(f["gt_image"]),
        gt_depth=None if f.get("gt_depth") is None else T(f["gt_depth"]),
        motion_mask=None, frame_idx=int(f["frame_idx"]),
        time=torch.tensor(float(f["time"])),
        fovx=torch.tensor(float(f["fovx"])),
        fovy=torch.tensor(float(f["fovy"]))) for f in batch_np])


def losses(terms) -> MultiLoss:
    return MultiLoss([LossTerm(*t) for t in terms])


# --------------------------------------------------------------------------
# render
# --------------------------------------------------------------------------


def render_cases(rank: int, jobs: list) -> list:
    """For each job (mesh shape, scene, cases), each case (name, render
    kwargs, uses_gauss, grads) renders the scene with tile_axis = the
    composite axis and (uses_gauss) gauss_axis = "gauss", and (grads)
    differentiates mean((image - gt)^2) / n_comp in xyz and the raw
    opacity: the planes, radii, visibility and this rank's block of the
    gradients, summed over the tile axis. One dict per job."""
    out = []
    for shape, scene, cases in jobs:
        mesh = mesh_of(shape)
        comp = S.composite_axes(mesh)
        n_comp = shape["gauss"] * shape["tile"]
        cam = make_camera(*scene["camera"], device="cpu")
        res_job = {}
        for name, kw, uses_gauss, grads in cases:
            g, n = mesh.coords["gauss"], shape["gauss"]
            block = ((lambda x: S._block(T(x), g, n)) if uses_gauss
                     else (lambda x: T(x)))
            xyz = block(scene["xyz"]).requires_grad_(grads)
            opac = block(scene["opacity"]).requires_grad_(grads)
            res = R.render(
                xyz, block(scene["shs"]), torch.sigmoid(opac[:, 0]),
                block(scene["scaling"]), block(scene["rotation"]), cam,
                scene["sh_degree"], scene["W"], scene["H"],
                alive=block(scene["alive"]), tile_axis=comp,
                gauss_axis=mesh.axis("gauss") if uses_gauss else None, **kw)
            got = {"image": npy(res["rendered_image"]),
                   "depth": npy(res["rendered_depth"]),
                   "alpha": npy(res["rendered_alpha"]),
                   "radii": npy(res["radii"])}
            if grads:
                loss = ((res["rendered_image"] - T(scene["gt"])) ** 2).mean()
                g_xyz, g_op = C.psum(list(torch.autograd.grad(
                    loss / n_comp, [xyz, opac])), mesh.axis("tile"))
                got.update(g_xyz=npy(g_xyz), g_opacity=npy(g_op))
            res_job[name] = got
        out.append({"coords": mesh.coords, "cases": res_job})
    return out


# --------------------------------------------------------------------------
# the sharded steps
# --------------------------------------------------------------------------


def _static_state(s: dict) -> StaticTrainState:
    return StaticTrainState(
        store=convert.store_from_numpy(s["store"], "cpu"),
        opt=convert.adam_from_numpy(s["opt"], G.GaussianParams, "cpu"),
        stats=convert.stats_from_numpy(s["stats"], "cpu"),
        poses=convert.poses_from_numpy(s["poses"], "cpu"),
        cam_opt=convert.adam_from_numpy(s["cam_opt"], CameraPoses, "cpu"))


def _groups(mesh) -> dict:
    """Each axis's members, as its collectives see them: every rank's
    global rank gathered over the axis."""
    me = torch.tensor([mesh.rank])
    return {"/".join(names): C.all_gather(me, mesh.axis(names)).tolist()
            for names in (("data",), ("gauss",), ("tile",),
                          ("gauss", "tile"))}


def static_step(rank: int, shape: dict, setup: dict) -> dict:
    """One sharded static step from the global numpy state: the gradients
    (global layout), the metrics and the new global state."""
    mesh = mesh_of(shape)
    cfg = StaticTrainerConfig(**setup["cfg"])
    loss = losses(setup["loss"])
    state = S.static_state_block(_static_state(setup["state"]), mesh)
    step = S.make_sharded_static_step(cfg, loss, mesh, 3.0,
                                      torch.Generator().manual_seed(0))
    batch = frames(setup["batch"])
    it = setup["iteration"]
    grads = step.grads(state, batch, loss.active_set(it), setup["sh_degree"])
    new = step.update(state, grads, float(it), batch.frame_idx)
    gauss = mesh.axis("gauss")
    g_params, stat_delta = C.all_gather_rows((grads[1], grads[3]), gauss)
    new = S.static_state_global(new, mesh)
    out = {"coords": mesh.coords, "groups": _groups(mesh),
           "loss": float(grads[0]),
           "frag": [int(grads[4]), int(grads[5]), int(grads[6])]}
    if rank == 0:
        out.update(g_params=npy(g_params), g_poses=npy(grads[2]),
                   stat_delta=npy(stat_delta), state=npy(new))
    return out


def _dyn_trainer(setup: dict) -> DynTrainer:
    dt = DynTrainer(DynTrainerConfig(**setup["cfg"]), losses(setup["loss"]),
                    convert.store_from_numpy(setup["dyn"]["store"], "cpu"),
                    3.0, device="cpu")
    dt.state = convert.dyn_state_from_numpy(setup["dyn"], "cpu")
    dt.unique_times = T(setup["unique_times"])
    return dt


def dynamic_step(rank: int, shape: dict, setup: dict) -> dict:
    """One sharded dynamic step: the gradients, the metrics and the new
    dynamic state (whole on every rank)."""
    mesh = mesh_of(shape)
    dt = _dyn_trainer(setup)
    step = S.make_sharded_dynamic_step(dt, mesh)
    static = tree_map(
        lambda x: S._block(x, mesh.coords["gauss"], shape["gauss"]),
        convert.store_from_numpy(setup["static_store"], "cpu"))
    poses = convert.poses_from_numpy(setup["poses"], "cpu")
    batch = frames(setup["batch"])
    it = setup["iteration"]
    grads = step.grads(dt.state, static, poses, batch,
                       dt.loss.active_set(it), setup["sh_degree"],
                       use_deform=True)
    new = step.update(dt.state, grads, float(it))
    out = {"loss": float(grads[0]),
           "frag": [int(grads[3]), int(grads[4]), int(grads[5])]}
    if rank == 0:
        out.update(g_params=npy(grads[1]), stat_delta=npy(grads[2]),
                   state=convert.dyn_state_to_numpy(new))
    return out


def _same_split_noise(draws):
    """The port's split samples: the given numpy draws, in call order (each
    gauss shard draws the same, as a JAX shard_map traces one body)."""
    queue = [np.array(d) for d in draws]

    def split_noise(generator, capacity, device):
        return T(queue.pop(0)), T(queue.pop(0))

    D.split_noise = split_noise


def densify_both(rank: int, shape: dict, setup: dict) -> dict:
    """Both sharded densifications from global numpy states, the split
    samples replaced by the given draws."""
    mesh = mesh_of(shape)
    cfg = StaticTrainerConfig(**setup["static_cfg"])
    st = ThreeDGSTrainer(cfg, losses(setup["loss"]),
                         convert.store_from_numpy(setup["static"]["store"],
                                                  "cpu"),
                         convert.poses_from_numpy(setup["static"]["poses"],
                                                  "cpu"), 3.0, device="cpu")
    state = S.static_state_block(_static_state(setup["static"]), mesh)
    _same_split_noise(setup["static_draws"])
    new, info = S.make_sharded_densify(st.densify_block, mesh)(state, None)
    new = S.static_state_global(new, mesh)

    dt = _dyn_trainer(setup["dynamic"])
    _same_split_noise(setup["dynamic_draws"])
    dnew, dinfo = S.make_sharded_dynamic_densify(dt.densify_block, mesh)(
        dt.state, None)
    out = {"info": npy(info), "dyn_info": npy(dinfo),
           "dyn_state": convert.dyn_state_to_numpy(dnew)}
    if rank == 0:
        out["state"] = npy(new)
    return out


# --------------------------------------------------------------------------
# multihost, resume files
# --------------------------------------------------------------------------


def multihost_calls(rank: int, shared: str) -> dict:
    """The five functions in a world of several processes."""
    flag = MH.broadcast_flag(rank == 0)
    path = os.path.join(shared, "late_file")
    if rank == 0:
        time.sleep(0.5)
        with open(path, "w") as f:
            f.write("x")
    t0 = time.monotonic()
    MH.wait_for_path(path, timeout_s=30.0)
    waited = time.monotonic() - t0
    missing = None
    try:
        MH.wait_for_path(os.path.join(shared, "never"), timeout_s=0.3)
    except FileNotFoundError as e:
        missing = str(e)
    MH.barrier()
    # the collectives over the world: a tree psum / pmean / pmax, and the
    # gather whose backward hands each rank the sum of its block's
    # cotangents
    world = mesh_of({"data": MH.process_count(), "gauss": 1,
                     "tile": 1}).world
    x = torch.tensor([rank + 1.0, 10.0 * rank])
    tree = {"a": x, "b": (x[:1].to(torch.int32),)}
    leaf = torch.full((2, 1), float(rank), requires_grad=True)
    gathered = C.all_gather(leaf, world, dim=1)
    (g,) = torch.autograd.grad((gathered * torch.arange(
        1.0, 1.0 + gathered.numel()).reshape(gathered.shape)).sum(), [leaf])
    return {"primary": MH.is_primary(), "index": MH.process_index(),
            "count": MH.process_count(), "flag": flag, "waited": waited,
            "missing": missing,
            "initialized": MH.maybe_initialize_distributed(),
            "psum": npy(C.psum(tree, world)), "pmean": npy(C.pmean(x, world)),
            "pmax": npy(C.pmax(tree, world)), "gathered": npy(gathered),
            "gather_grad": npy(g),
            "alive": npy(C.all_gather_rows(torch.tensor([rank == 0, True]),
                                           world))}


def _run_on_mesh(shape: dict, setup: dict):
    """The training run of a config on the mesh (the same on every rank)."""
    from rodygs_tpu_torch.pipelines.build import build_training_run

    return build_training_run(setup["config"], dirpath=setup["dirpath"],
                              seed=3, capacity_factor=2.0,
                              mesh=mesh_of(shape))


def resume_write_run(rank: int, shape: dict, setup: dict, path: str) -> dict:
    """Values off the initial ones (the static rows per gauss block), then
    save_resume; rank 0 returns the global state the file should hold."""
    joint = _run_on_mesh(shape, setup).joint
    st, dyn = joint.static, joint.dynamic
    gen = torch.Generator().manual_seed(100 + joint.mesh.coords["gauss"])

    def moved(x):
        if not x.is_floating_point():
            return x
        return x + torch.rand(x.shape, generator=gen)

    st.state = S._with_static_rows(st.state, tree_map(
        moved, S._static_rows(st.state)))
    gen.manual_seed(7)
    dyn.state = dyn.state._replace(motion_coeff=moved(dyn.state.motion_coeff),
                                   stats=tree_map(moved, dyn.state.stats))
    st.active_sh_degree = 1
    joint.save_resume(path, 7)
    glob = st.global_state()
    if rank:
        return {}
    return {"static": npy(glob), "dynamic": npy(dyn.state)}


def resume_read_run(rank: int, shape: dict, setup: dict, path: str) -> dict:
    """load_resume on the mesh: this rank's block and the gathered global
    state."""
    joint = _run_on_mesh(shape, setup).joint
    nxt = joint.load_resume(path)
    st = joint.static
    return {"next": nxt, "sh": st.active_sh_degree,
            "gauss": joint.mesh.coords["gauss"],
            "block_xyz": npy(st.state.store.params.xyz),
            "static": npy(st.global_state()),
            "dynamic": npy(joint.dynamic.state)}


def scaling_sweep(rank: int, argv: list) -> dict:
    """`tools/scaling_bench`'s sweep on this world (every rank returns the
    summary; the rows are the same on every rank)."""
    from rodygs_tpu_torch.tools import scaling_bench

    return scaling_bench.run(scaling_bench.build_parser().parse_args(argv))


def sub_mesh_groups(rank: int) -> dict:
    """Meshes over the first ranks of a 4-rank world: 2 x 1 x 1 on ranks
    0-1 and 1 x 3 x 1 on ranks 0-2 (the ranks past them get None), then
    the whole world as 1 x 1 x 4; each rank's coordinates, its groups'
    members (every rank's global rank gathered over each axis) and a psum
    over the mesh."""
    out = {}
    for tag, shape, ranks in (("d2", (2, 1, 1), 2),
                              ("g3", (1, 3, 1), 3),
                              ("t4", (1, 1, 4), None)):
        mesh = make_mesh(n_data=shape[0], n_gauss=shape[1], n_tile=shape[2],
                         device="cpu", ranks=ranks)
        out[tag] = None if mesh is None else {
            "coords": mesh.coords, "world_size": mesh.world_size,
            "groups": _groups(mesh),
            "sum": float(C.psum(torch.tensor([float(rank)]), mesh.world)[0])}
    return out
