"""Joint static + dynamic trainer, the top of the training stack. Port of
`rodygs_tpu/train/trainer_joint.py` (`RoDyGSTrainer`: the dynamic step,
`train_iteration`, `save_checkpoints`, `save_resume` / `load_resume`).

Per iteration: (1) the static step, which renders the static set alone and
trains the static Gaussians and the camera poses; (2) the static model's
densification on its schedule; (3) the dynamic step, which renders the
static set concatenated with the deformed dynamic set but trains only the
dynamic model (the static params and poses enter it detached, and only the
dynamic slice of the screen-space gradients feeds its statistics); (4) the
dynamic model's densification. The SH degree ramps on the joint schedule
and is mirrored to the dynamic model. The joint trainer never resets
opacity. One pose array, owned by the static trainer, serves both steps
(the dynamic stage's camera learning rates are 0 in every shipped config).

Resume files are checkpoints (utils/checkpoint.py) that both packages
read: the two trainers' state trees share their field names with the JAX
package's. The port stores its `torch.Generator` states under
`torch_generators` and also writes the uint32 [2] `rng_key` the JAX loader
wraps (the key data of `jax.random.key(seed)` of the static generator's
seed). A resume across packages carries the state, not the random draws.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models import gaussians as G
from ..render.rasterize import render
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .densify import accumulate_stats
from .optim import CameraPoses, adam_update, tree_leaves, tree_map
from .trainer_dynamic import DynParams, DynTrainer, DynTrainState
from .trainer_static import (EscalationPoller, FrameBatch, ThreeDGSTrainer,
                             densify_due, make_camera_from_poses,
                             scene_lr_gate, screen_size_threshold)


class RoDyGSTrainer:
    def __init__(self, static_trainer: ThreeDGSTrainer,
                 dynamic_trainer: DynTrainer | None,
                 sh_up_start_iteration: int = 0,
                 sh_up_period: int = 1000,
                 log_freq: int = 50,
                 logdir: str | Path | None = None):
        self.static = static_trainer
        self.dynamic = dynamic_trainer
        self.skip_dynamic = dynamic_trainer is None
        self.sh_up_start_iteration = sh_up_start_iteration
        self.sh_up_period = sh_up_period
        self.log_freq = log_freq
        self.logdir = Path(logdir) if logdir is not None else None
        if not self.skip_dynamic:
            self.dyn_fragment_profile: str | int = "lean"
            self._dyn_escalation = EscalationPoller()

    def dyn_step(self, dyn_state: DynTrainState, static_store: G.GaussianStore,
                 poses: CameraPoses, batch: FrameBatch, iteration,
                 active, sh_degree: int, use_deform: bool,
                 fragment_profile="lean"):
        """One dynamic step from `dyn_state`; returns (new_state, metrics)."""
        dyn = self.dynamic
        cfg = dyn.cfg
        sp = static_store.params
        cs = G.capacity_of(static_store)
        cd = G.capacity_of(dyn_state.store)
        old = DynParams(gauss=dyn_state.store.params,
                        motion_coeff=dyn_state.motion_coeff, net=dyn_state.net)
        params = tree_map(lambda x: x.detach().requires_grad_(True), old)
        offset = torch.zeros((2, cs + cd), device=dyn.device,
                             requires_grad=True)
        gp = params.gauss
        if use_deform:
            transl, rot_delta = dyn.deformation(
                params, batch.time, dyn_state.store.time_ind)
        else:
            transl = torch.zeros_like(gp.xyz)
            rot_delta = torch.zeros((cd, 4), device=dyn.device)
        d_alive = dyn_state.store.alive
        dyn_rot = G.get_rotation(gp)
        if not cfg.isotropic:
            dyn_rot = dyn_rot + rot_delta
        out = render(
            torch.cat([sp.xyz.detach(), gp.xyz + transl]),
            torch.cat([G.get_features(sp).detach(), G.get_features(gp)]),
            torch.cat([G.get_opacity(sp).detach(), G.get_opacity(gp)]),
            torch.cat([G.get_scaling(sp, cfg.isotropic).detach(),
                       G.get_scaling(gp, cfg.isotropic)]),
            torch.cat([G.get_rotation(sp).detach(), dyn_rot]),
            make_camera_from_poses(CameraPoses(*[p.detach() for p in poses]),
                                   batch),
            sh_degree, cfg.image_width, cfg.image_height,
            alive=torch.cat([static_store.alive, d_alive]),
            means2d_offset=offset, max_fragments=cfg.max_fragments,
            fragment_profile=fragment_profile,
            include_normal=dyn.loss.uses_normal)
        ctx = {
            "pred_img": out["rendered_image"],
            "gt_img": batch.gt_image,
            "pred_depth": out["rendered_depth"],
            "gt_depth": batch.gt_depth,
            "pred_normal": out["rendered_normal"],
            "motion_mask": batch.motion_mask,
            "rng": dyn.gen,
            # the model terms read the dynamic slice
            "motion_coeff": params.motion_coeff,
            "canon_xyz": gp.xyz,
            "features_dc": gp.features_dc,
            "pred_translation": transl,
            "alive": d_alive,
            "motion_table": dyn.motion_table(params),
        }
        total, loss_dict = dyn.loss(ctx, active)
        leaves = tree_leaves(params) + [offset]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = iter([torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads)])
        g_params = tree_map(lambda _: next(grads), params)
        g_offset = next(grads)

        gate = scene_lr_gate(cfg, iteration)
        new_params, new_opt = adam_update(
            g_params, dyn_state.opt, old, dyn.lr_tree(iteration),
            update_gate=gate if cfg.scene_lr_delay > 0 else None)
        new_stats = accumulate_stats(
            dyn_state.stats, g_offset[:, cs:],
            out["radii"][cs:].to(torch.float32),
            out["visibility_filter"][cs:])
        new_state = dyn_state._replace(
            store=dyn_state.store._replace(params=new_params.gauss),
            motion_coeff=new_params.motion_coeff, net=new_params.net,
            opt=new_opt, stats=new_stats)
        metrics = {"loss": total.detach(), "overflow": out["overflow"],
                   "dropped": out["dropped"],
                   "num_fragments": out["num_fragments"],
                   **{k: v.detach() for k, v in loss_dict.items()}}
        return new_state, metrics

    def train_iteration(self, static_batch: FrameBatch,
                        dynamic_batch: FrameBatch | None,
                        iteration: int) -> dict[str, Any]:
        st = self.static
        if (iteration > self.sh_up_start_iteration
                and iteration % self.sh_up_period == 0):
            st.active_sh_degree = G.sh_degree_up(st.active_sh_degree,
                                                 st.cfg.sh_degree)
        metrics = {}
        st.state, m_static = st.step(
            st.state, static_batch, float(iteration),
            st.loss.active_set(iteration), st.active_sh_degree,
            st.fragment_profile)
        metrics["static"] = m_static
        wider = st._escalation.poll(iteration, m_static,
                                    G.capacity_of(st.state.store),
                                    st.fragment_profile)
        if wider is not None:
            st.fragment_profile = wider
        if densify_due(st.cfg, iteration):
            st.state, metrics["static_densify"] = st.densify(
                st.state, screen_size_threshold(st.cfg, iteration))

        if not self.skip_dynamic:
            dyn = self.dynamic
            dyn.active_sh_degree = st.active_sh_degree
            dyn.state, m_dyn = self.dyn_step(
                dyn.state, st.state.store, st.state.poses, dynamic_batch,
                float(iteration), dyn.loss.active_set(iteration),
                dyn.active_sh_degree,
                use_deform=iteration > dyn.cfg.deform_warmup_steps,
                fragment_profile=self.dyn_fragment_profile)
            metrics["dynamic"] = m_dyn
            # the dynamic step renders the concatenated set: its capacity is
            # sized against the combined store
            wider = self._dyn_escalation.poll(
                iteration, m_dyn,
                G.capacity_of(st.state.store) + G.capacity_of(dyn.state.store),
                self.dyn_fragment_profile)
            if wider is not None:
                self.dyn_fragment_profile = wider
            info = dyn.maybe_densify(iteration)
            if info is not None:
                metrics["dynamic_densify"] = info
        return metrics

    def save_checkpoints(self, iteration: int) -> None:
        """Write `static_last.ckpt` and (with a dynamic model)
        `dynamic_last.ckpt` under `logdir`, in the JAX package's checkpoint
        format (utils/checkpoint.py): either package's evaluator reads
        them. One process writes; there is no barrier."""
        if self.logdir is None:
            raise ValueError("save_checkpoints needs the trainer's logdir")
        save_checkpoint(self.logdir / "static_last.ckpt",
                        self.static.state_dict(iteration), iteration)
        if not self.skip_dynamic:
            save_checkpoint(self.logdir / "dynamic_last.ckpt",
                            self.dynamic.state_dict(iteration), iteration)

    # --- mid-training resume ----------------------------------------------

    def save_resume(self, path, iteration: int) -> None:
        """Write the trainers' whole state after `iteration`."""
        gens = {"static": self.static.gen}
        payload = {
            "iteration": iteration,
            "rng_key": np.array(
                [0, self.static.gen.initial_seed() & 0xFFFFFFFF], np.uint32),
            "static": {"state": self.static.state,
                       "sh": self.static.active_sh_degree},
        }
        if not self.skip_dynamic:
            gens["dynamic"] = self.dynamic.gen
            payload["dynamic"] = {
                "state": self.dynamic.state,
                "sh": self.dynamic.active_sh_degree,
                "unique_times": self.dynamic.unique_times}
        payload["torch_generators"] = {
            k: g.get_state().numpy() for k, g in gens.items()}
        save_checkpoint(path, payload, iteration)

    def load_resume(self, path) -> int:
        """Restore the trainers' state from a resume file written by either
        package; returns the next iteration. The generators are restored
        from a file of the port's; a JAX-written file leaves them as they
        are."""
        payload, iteration = load_checkpoint(path)
        st = self.static
        st.state = _restore(st.state, payload["static"]["state"])
        st.active_sh_degree = int(payload["static"]["sh"])
        gens = payload.get("torch_generators", {})
        if "static" in gens:
            st.gen.set_state(torch.from_numpy(np.array(gens["static"])))
        if not self.skip_dynamic and "dynamic" in payload:
            dyn = self.dynamic
            dyn.state = _restore(dyn.state, payload["dynamic"]["state"])
            dyn.active_sh_degree = int(payload["dynamic"]["sh"])
            dyn.unique_times = torch.tensor(
                np.array(payload["dynamic"]["unique_times"], np.float32),
                device=dyn.device)
            if "dynamic" in gens:
                dyn.gen.set_state(torch.from_numpy(np.array(gens["dynamic"])))
        return iteration + 1


def _restore(like, loaded):
    """`loaded` (numpy leaves, in a tree of the same shape as `like`) as
    tensors on `like`'s devices with `like`'s dtypes."""
    if isinstance(like, dict):
        if sorted(like) != sorted(loaded):
            raise ValueError(f"resume keys {sorted(loaded)} != {sorted(like)}")
        return {k: _restore(v, loaded[k]) for k, v in like.items()}
    if isinstance(like, tuple):
        if len(like) != len(loaded):
            raise ValueError(f"resume node of {len(loaded)} fields, expected "
                             f"{type(like).__name__} of {len(like)}")
        kids = [_restore(a, b) for a, b in zip(like, loaded)]
        return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)
    if like is None:
        return None
    return torch.as_tensor(np.array(loaded), device=like.device).to(like.dtype)
