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

Multi-device (`mesh=`, the trainers built on the same mesh): the dynamic
step is parallel/sharded.py's, on the stacked batches. One process
writes: checkpoints and resume files hold the global arrays (the gauss
blocks gathered on every rank, the primary writes, then every rank meets
at a barrier), so they are the single-device files both packages read;
`load_resume` waits for the file and each rank takes its own block.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..models import gaussians as G
from ..parallel.multihost import barrier, is_primary, wait_for_path
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.profiling import span
from .densify import accumulate_stats
from .optim import CameraPoses
from .trainer_dynamic import DynTrainer, DynTrainState
from .trainer_static import (EscalationPoller, FrameBatch, ThreeDGSTrainer,
                             densify_due, screen_size_threshold)


class RoDyGSTrainer:
    def __init__(self, static_trainer: ThreeDGSTrainer,
                 dynamic_trainer: DynTrainer | None,
                 sh_up_start_iteration: int = 0,
                 sh_up_period: int = 1000,
                 log_freq: int = 50,
                 logdir: str | Path | None = None,
                 mesh=None):
        self.mesh = mesh
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
            if mesh is not None:
                from ..parallel.sharded import make_sharded_dynamic_step

                self._sharded_dyn_step = make_sharded_dynamic_step(
                    self.dynamic, mesh)

    def dyn_step(self, dyn_state: DynTrainState, static_store: G.GaussianStore,
                 poses: CameraPoses, batch: FrameBatch, iteration,
                 active, sh_degree: int, use_deform: bool,
                 fragment_profile="lean"):
        """One dynamic step from `dyn_state`; returns (new_state, metrics).
        On a mesh `static_store` is this rank's block and `batch` stacked."""
        if self.mesh is not None:
            return self._sharded_dyn_step(
                dyn_state, static_store, poses, batch, iteration, active,
                sh_degree, use_deform, fragment_profile)
        dyn = self.dynamic
        cs = G.capacity_of(static_store)
        total, aux, (g_params, g_offset) = dyn.loss_and_grads(
            dyn_state, static_store, poses, batch, active, sh_degree,
            use_deform, fragment_profile)
        with span("optim"):
            # only the dynamic slice of the screen gradients feeds its stats
            new_stats = accumulate_stats(
                dyn_state.stats, g_offset[:, cs:],
                aux["radii"][cs:].to(torch.float32), aux["visible"][cs:])
            new_state = dyn.apply_update(dyn_state, g_params, new_stats,
                                         iteration)
        metrics = {"loss": total, "overflow": aux["overflow"],
                   "dropped": aux["dropped"],
                   "num_fragments": aux["num_fragments"],
                   **aux["loss_dict"]}
        return new_state, metrics

    @span("iteration")
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
        wider = st._escalation.poll(iteration, m_static, st.capacity(),
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
                st.capacity() + G.capacity_of(dyn.state.store),
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
        them. Every process calls it; the primary writes, then all meet at
        a barrier."""
        if self.logdir is None:
            raise ValueError("save_checkpoints needs the trainer's logdir")
        static_sd = self.static.state_dict(iteration)
        if is_primary():
            self.logdir.mkdir(parents=True, exist_ok=True)
            save_checkpoint(self.logdir / "static_last.ckpt", static_sd,
                            iteration)
            if not self.skip_dynamic:
                save_checkpoint(self.logdir / "dynamic_last.ckpt",
                                self.dynamic.state_dict(iteration), iteration)
        barrier("rodygs_ckpt")

    # --- mid-training resume ----------------------------------------------

    def _densify_gens(self) -> dict:
        """The per-gauss-shard split generators' states, by shard (a
        collective on a mesh with a gauss axis)."""
        import torch.distributed as dist

        trainers = {"static": self.static}
        if not self.skip_dynamic:
            trainers["dynamic"] = self.dynamic
        mine = {k: t.densify_gen.get_state().numpy()
                for k, t in trainers.items()}
        if self.mesh is None or self.mesh.shape["gauss"] == 1:
            return {}
        every = [None] * self.mesh.world_size
        dist.all_gather_object(every, (self.mesh.coords["gauss"], mine))
        return {f"{k}_densify": [dict(every)[g][k]
                                 for g in range(self.mesh.shape["gauss"])]
                for k in trainers}

    def save_resume(self, path, iteration: int) -> None:
        """Write the trainers' whole state after `iteration` (every process
        calls it; the primary writes, then all meet at a barrier)."""
        gens = {"static": self.static.gen}
        payload = {
            "iteration": iteration,
            "rng_key": np.array(
                [0, self.static.gen.initial_seed() & 0xFFFFFFFF], np.uint32),
            "static": {"state": self.static.global_state(),
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
        payload["torch_generators"].update(self._densify_gens())
        if is_primary():
            save_checkpoint(path, payload, iteration)
        barrier("rodygs_ckpt")

    def load_resume(self, path) -> int:
        """Restore the trainers' state from a resume file written by either
        package; returns the next iteration. The generators are restored
        from a file of the port's; a JAX-written file leaves them as they
        are. On a mesh every process calls it, after the writer's barrier
        (`broadcast_flag` the decision when it rests on a filesystem
        check); each rank keeps its own gauss block."""
        wait_for_path(path)
        payload, iteration = load_checkpoint(path)
        st = self.static
        st.state = _restore(st.state, payload["static"]["state"])
        if self.mesh is not None:
            from ..parallel.sharded import static_state_block

            st.state = static_state_block(st.state, self.mesh)
        st.active_sh_degree = int(payload["static"]["sh"])
        gens = payload.get("torch_generators", {})
        if "static" in gens:
            st.gen.set_state(torch.from_numpy(np.array(gens["static"])))
        g = 0 if self.mesh is None else self.mesh.coords["gauss"]
        for name, trainer in (("static", st), ("dynamic", self.dynamic)):
            if f"{name}_densify" in gens:
                trainer.densify_gen.set_state(torch.from_numpy(
                    np.array(gens[f"{name}_densify"][g])))
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
