"""Traffic `joint`: the joint RoDyGS iteration (`RoDyGSTrainer.
train_iteration`, the static step then the dynamic step) on one seeded
scene, one frame per iteration in the order `data/sampler.py` draws them
(a fresh permutation of the frames per epoch from the seed), the same frame
for both steps. Parameters (the cell's file):

  first_iteration   the number of the first iteration (the learning-rate
                    schedules read it; rigidity runs on multiples of 5)
  window_first      the number of the first timed iteration; the
                    iterations before it are the warm-up
  initial_profile   the fragment profile both renders start at, wide
                    enough that the first iterations drop nothing; the
                    program's poller fits it at its poll iterations
  follow            how many iterations the reference follows in each of
                    two stretches: the first iterations, from the
                    harness's inputs, and the last before the window, from
                    the program's state (at the profile the window starts
                    at)
  profiled          iterations in a traced run's profile, from a number
                    = 1 mod 5 and past no densification

`Session` drives the program; `reference_stretches` runs the reference.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import scene as S
from ..reference import step as R
from ..reference.optim import tree_map

FRAME_STREAM = 1 << 14
ADAM_B1 = 0.9


def frame_order(seed: int, frames: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = -(-FRAME_STREAM // frames)
    return np.concatenate([rng.permutation(frames) for _ in range(n)])


def trainer_seeds(seed: int) -> tuple[int, int]:
    """The seeds of the static and the dynamic trainer's generators."""
    return seed + 1, seed + 2


class Follow(NamedTuple):
    """What one side did on the iterations of a followed stretch."""

    losses: list        # [(static, dynamic)] per iteration, floats
    first_grads: dict   # leaf name -> the first iteration's gradient
    params: dict        # leaf name -> value after the last one
    dropped: int        # iterations whose renders dropped fragments


class Followed(NamedTuple):
    """The program's two followed stretches, and the state (on the host, in
    the reference's types) and generator states the second starts from."""

    start: Follow
    state: R.State
    gen_states: tuple
    window: Follow


def first_gradients(mu0: dict | None, mu1: dict) -> dict:
    """The first iteration's gradient as each Adam holds it, from the first
    moments before and after: (mu_1 - b1 mu_0) / (1 - b1), in float64."""
    out = {}
    for n, m in mu1.items():
        m = m.to(torch.float64)
        if mu0 is not None:
            m = m - ADAM_B1 * mu0[n].to(torch.float64)
        out[n] = m / (1.0 - ADAM_B1)
    return out


def named_leaves(prefix: str, tree) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(named_leaves(f"{prefix}.{k}", v))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(named_leaves(f"{prefix}.{k}", v))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            out.update(named_leaves(f"{prefix}.{i}", v))
    else:
        out[prefix] = tree
    return out


def leaf_dict(static, poses, gauss, coeff, net, stats=()) -> dict:
    """Every trained leaf by name ("static.0", "poses.1",
    "dynamic.net.timenet.w0", ...), and the named statistics."""
    out = named_leaves("static", tuple(static))
    out.update(named_leaves("poses", tuple(poses)))
    out.update(named_leaves("dynamic.gauss", tuple(gauss)))
    out["dynamic.motion_coeff"] = coeff
    out.update(named_leaves("dynamic.net", net))
    for name, s in stats:
        out.update(named_leaves(name, tuple(s)))
    return out


def program_leaves(joint) -> dict:
    st, dyn = joint.static.state, joint.dynamic.state
    return leaf_dict(st.store.params, st.poses, dyn.store.params,
                     dyn.motion_coeff, dyn.net,
                     (("static_stats", st.stats), ("dynamic_stats",
                                                   dyn.stats)))


def program_moments(joint) -> dict:
    st, dyn = joint.static.state, joint.dynamic.state
    mu = dyn.opt.mu
    return leaf_dict(st.opt.mu, st.cam_opt.mu, mu.gauss, mu.motion_coeff,
                     mu.net)


def reference_leaves(s: R.State) -> dict:
    return leaf_dict(s.static, s.poses, s.dynamic.gauss,
                     s.dynamic.motion_coeff, s.dynamic.net,
                     (("static_stats", s.static_stats), ("dynamic_stats",
                                                         s.dyn_stats)))


def reference_moments(s: R.State) -> dict:
    mu = s.dyn_opt.mu
    return leaf_dict(s.static_opt.mu, s.cam_opt.mu, mu.gauss,
                     mu.motion_coeff, mu.net)


def input_leaves(inputs) -> dict:
    """The trained leaves of the harness's inputs (`Session.inputs`)."""
    static, _, poses, dynamic, _, _, _ = inputs
    return leaf_dict(static, poses, dynamic.gauss, dynamic.motion_coeff,
                     dynamic.net)


class Session:
    """The program's joint trainer on the scene, from `first_iteration`."""

    def __init__(self, cfg: dict, params: dict, seed: int, device):
        from rodygs_tpu_torch.models import gaussians as G
        from rodygs_tpu_torch.train.losses import MultiLoss
        from rodygs_tpu_torch.train.optim import CameraPoses
        from rodygs_tpu_torch.train.trainer_dynamic import (DynTrainer,
                                                            DynTrainerConfig)
        from rodygs_tpu_torch.train.trainer_joint import RoDyGSTrainer
        from rodygs_tpu_torch.train.trainer_static import (FrameBatch,
                                                           StaticTrainerConfig,
                                                           ThreeDGSTrainer)

        self.params = params
        self.device = torch.device(device)
        sc = S.build(cfg, seed, self.device)
        self.frames = sc.frames
        # the reference's copy of the inputs, off the card while the
        # program runs
        self.inputs = tree_map(
            lambda x: x.detach().to("cpu", copy=True),
            (sc.static, sc.static_alive, sc.poses, sc.dynamic, sc.dyn_alive,
             sc.time_ind, sc.unique_times))
        tc = cfg["trainer"]
        static_kw = {k: v for k, v in tc["static"].items() if k != "losses"}
        dyn_kw = {k: v for k, v in tc["dynamic"].items() if k != "losses"}
        size = dict(image_width=sc.width, image_height=sc.height)

        def store(p, alive, time, time_ind):
            return G.GaussianStore(params=G.GaussianParams(*p), alive=alive,
                                   time=time, time_ind=time_ind)

        zeros_t = torch.zeros_like(sc.dyn_time)
        s_seed, d_seed = trainer_seeds(seed)
        st = ThreeDGSTrainer(
            StaticTrainerConfig(**size, **static_kw),
            MultiLoss.from_config(tc["static"]["losses"]),
            store(sc.static, sc.static_alive, zeros_t, torch.zeros_like(
                sc.time_ind)),
            CameraPoses(*[p.clone() for p in sc.poses]),
            tc["spatial_lr_scale"], device=self.device, seed=s_seed)
        dt = DynTrainer(
            DynTrainerConfig(**size, **dyn_kw),
            MultiLoss.from_config(tc["dynamic"]["losses"]),
            store(sc.dynamic.gauss, sc.dyn_alive, sc.dyn_time, sc.time_ind),
            tc["spatial_lr_scale"], seed=d_seed, device=self.device)
        # the harness's motion coefficients and net, and the generator as
        # seeded (the trainer drew its own init net from it)
        dt.state = dt.state._replace(motion_coeff=sc.dynamic.motion_coeff,
                                     net=sc.dynamic.net)
        dt.gen.manual_seed(d_seed)
        self.joint = RoDyGSTrainer(
            st, dt, sh_up_start_iteration=tc["sh_up_start_iteration"],
            sh_up_period=tc["sh_up_period"])
        st.fragment_profile = params["initial_profile"]
        self.joint.dyn_fragment_profile = params["initial_profile"]
        self.order = frame_order(seed, cfg["frames"])
        f32 = lambda x: torch.tensor(x, dtype=torch.float32,
                                     device=self.device)
        self.batches = [FrameBatch(
            gt_image=f.gt_image, gt_depth=f.gt_depth, motion_mask=None,
            frame_idx=f.frame_idx, time=f32(f.time), fovx=f32(f.fovx),
            fovy=f32(f.fovy)) for f in sc.frames]
        self.iteration = params["first_iteration"]

    def step(self) -> dict:
        """One joint iteration; returns its metrics."""
        it = self.iteration
        b = self.batches[self.order[it - self.params["first_iteration"]]]
        m = self.joint.train_iteration(b, b, it)
        self.iteration += 1
        return m

    def follow(self, n: int, mu0: dict | None = None) -> Follow:
        """`n` iterations recorded for the reference; `mu0` holds the first
        moments before them (None: zero)."""
        losses, dropped, first = [], 0, None
        for k in range(n):
            m = self.step()
            losses.append((m["static"]["loss"], m["dynamic"]["loss"]))
            dropped += bool(int(m["static"]["dropped"])
                            or int(m["dynamic"]["dropped"]))
            if k == 0:
                first = first_gradients(
                    mu0, _cpu(program_moments(self.joint)))
        return Follow([(float(a), float(b)) for a, b in losses], first,
                      _cpu(program_leaves(self.joint)), dropped)

    def warm_up(self) -> Followed:
        """The iterations before the window: the first `follow` of them and
        the last `follow` are recorded for the reference, the second from a
        copy of the program's state before them."""
        n = self.params["follow"]
        start = self.follow(n)
        while self.iteration < self.params["window_first"] - n:
            self.step()
        state, gens = self.reference_state()
        window = self.follow(n, reference_moments(state))
        return Followed(start, state, gens, window)

    def reference_state(self) -> tuple:
        """The program's whole trained state (stores, poses, every Adam's
        moments and count, the densification statistics) on the host in
        the reference's types, and its two generators' states."""
        st, dyn = self.joint.static.state, self.joint.dynamic.state

        def gauss(p):
            return R.GaussianParams(*p)

        def dyn_params(p, coeff, net):
            return R.DynParams(gauss(p), coeff, net)

        def adam(o, tree):
            return R.AdamState(tree(o.mu), tree(o.nu), o.count)

        state = R.State(
            static=gauss(st.store.params), static_alive=st.store.alive,
            poses=tuple(st.poses), static_opt=adam(st.opt, gauss),
            cam_opt=adam(st.cam_opt, tuple),
            static_stats=R.Stats(*st.stats),
            dynamic=dyn_params(dyn.store.params, dyn.motion_coeff, dyn.net),
            dyn_alive=dyn.store.alive, time_ind=dyn.store.time_ind,
            dyn_opt=adam(dyn.opt, lambda m: dyn_params(
                m.gauss, m.motion_coeff, m.net)),
            dyn_stats=R.Stats(*dyn.stats))
        gens = (self.joint.static.gen.get_state(),
                self.joint.dynamic.gen.get_state())
        return _cpu(state), gens

    def window(self, seconds: float) -> dict:
        """Whole iterations until `seconds` have passed on the host clock;
        CUDA events on the current stream before the window and after each
        iteration, read after it."""

        def stamp():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        stamps = [stamp()]
        results, failed = [], 0
        t0 = time.perf_counter()
        while True:
            try:
                m = self.step()
                results.append((m["static"]["loss"], m["dynamic"]["loss"],
                                m["static"]["dropped"],
                                m["dynamic"]["dropped"]))
            except Exception as e:  # a raising iteration counts as failed
                failed += 1
                print(f"[joint] iteration {self.iteration - 1} raised {e!r}",
                      flush=True)
            stamps.append(stamp())
            if time.perf_counter() - t0 >= seconds:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        gaps = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        raised = failed
        dropping = nonfinite = 0
        for ls, ld, ds, dd in results:
            finite = bool(torch.isfinite(ls) and torch.isfinite(ld))
            dropped = int(ds) > 0 or int(dd) > 0
            nonfinite += not finite
            dropping += dropped
            failed += not finite or dropped
        n = len(gaps)
        return {"iterations": n, "failed": failed, "wall_s": wall,
                "failed_by": {"raised": raised, "non-finite loss": nonfinite,
                              "dropped fragments": dropping},
                "iteration_ms": wall * 1e3 / n, "event_ms": gaps,
                "peak_bytes": peak,
                "last_iteration": self.iteration - 1,
                "profiles": [str(self.joint.static.fragment_profile),
                             str(self.joint.dyn_fragment_profile)]}

    def render_inputs(self) -> dict:
        """The state both renders of the next iteration start from."""
        st, dyn = self.joint.static.state, self.joint.dynamic.state
        return _cpu({"static": tuple(st.store.params),
                     "static_alive": st.store.alive,
                     "poses": (st.poses.q_c2w, st.poses.t_c2w),
                     "dynamic": tuple(dyn.store.params),
                     "coeff": dyn.motion_coeff, "net": dyn.net,
                     "dyn_alive": dyn.store.alive,
                     "time_ind": dyn.store.time_ind,
                     "unique_times": self.joint.dynamic.unique_times})

    def close(self):
        del self.joint, self.batches
        torch.cuda.empty_cache()


def _cpu(tree):
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _reference_follow(ref: R.Reference, s: R.State, gens, frames, order,
                      first_it: int, n: int) -> Follow:
    """The reference over `n` iterations from `s`, numbered from
    `first_it`; frame k is `order[k]`."""
    losses, first = [], None
    mu0 = _cpu(reference_moments(s))
    for k in range(n):
        s, (ls, ld) = ref.iteration(s, frames[order[k]], first_it + k, gens)
        losses.append((float(ls), float(ld)))
        if k == 0:
            first = first_gradients(mu0, _cpu(reference_moments(s)))
    return Follow(losses, first, _cpu(reference_leaves(s)), 0)


def reference_stretches(cfg: dict, params: dict, seed: int, inputs, frames,
                        followed: Followed, device) -> tuple[Follow, Follow]:
    """The reference over both followed stretches: the first iterations
    from the harness's inputs and generator seeds, the last before the
    window from the program's state and generator states there."""
    to = lambda t: tree_map(lambda x: x.to(device), t)
    static, s_alive, poses, dynamic, d_alive, time_ind, unique = to(inputs)
    ref = R.Reference(cfg["trainer"], cfg["width"], cfg["height"], unique)
    s = R.initial_state(R.GaussianParams(*static), s_alive, tuple(poses),
                        R.DynParams(R.GaussianParams(*dynamic.gauss),
                                    dynamic.motion_coeff, dynamic.net),
                        d_alive, time_ind)
    gens = tuple(torch.Generator(device=device).manual_seed(x)
                 for x in trainer_seeds(seed))
    order = frame_order(seed, cfg["frames"])
    n, first = params["follow"], params["first_iteration"]
    start = _reference_follow(ref, s, gens, frames, order, first, n)

    gens = tuple(torch.Generator(device=device) for _ in range(2))
    for g, state in zip(gens, followed.gen_states):
        g.set_state(state)
    it = params["window_first"] - n
    window = _reference_follow(ref, to(followed.state), gens, frames,
                               order[it - first:], it, n)
    return start, window


def found_numbers(prog_start: Follow, prog_window: Follow, ref_start:
                  Follow, ref_window: Follow, inputs, state: R.State,
                  window_failed: int) -> dict:
    """Every number `correct` is decided on, {name: (value, where)}: the
    three gaps of each stretch, the followed iterations that dropped
    fragments, and the window's failed iterations."""
    from ..check import gaps

    found = {}
    for name, prog, ref, initial in (
            ("start", prog_start, ref_start, input_leaves(inputs)),
            ("window", prog_window, ref_window, reference_leaves(state))):
        for k, v in gaps(prog, ref, initial).items():
            found[f"{name}.{k}"] = v
    found["followed.dropped"] = (prog_start.dropped + prog_window.dropped,
                                 "followed iterations that dropped fragments")
    found["window.failed"] = (window_failed, "window iterations that raised, "
                              "gave a non-finite loss or dropped fragments")
    return found


def render_rows(cfg: dict, ref: R.Reference, snap_before: dict,
                snap_after: dict, frame: R.Frame, device) -> list:
    """The [10, N] splat rows and binning of both renders of one iteration,
    by the reference's projection and binning: the static render from the
    state before it, the dynamic render from the static state after the
    static step (no densification falls between) and the dynamic state
    before it."""
    from ..reference.preprocess import preprocess
    from ..reference.quaternion import quat_normalize
    from ..reference.render import bin_splats

    to = lambda t: tree_map(lambda x: x.to(device), t)
    before, after = to(snap_before), to(snap_after)
    w, h = cfg["width"], cfg["height"]

    def rows(xyz, shs, op, scale, rot, alive, poses):
        sp = preprocess(xyz, scale, rot, op, shs, 0, R._camera(poses, frame),
                        w, h, alive=alive)
        return (torch.cat([sp.mean2d, sp.conic, sp.opacity[None], sp.rgb,
                           sp.depth[None]]), bin_splats(sp, w, h))

    s0 = R.GaussianParams(*before["static"])
    out = [rows(s0.xyz, R.features(s0), R.opacity(s0), torch.exp(s0.scaling),
                s0.rotation, before["static_alive"], before["poses"])]
    s1 = R.GaussianParams(*after["static"])
    gp = R.GaussianParams(*before["dynamic"])
    transl, rot_delta = ref.deformation(
        R.DynParams(gp, before["coeff"], before["net"]), frame.time,
        before["time_ind"])
    out.append(rows(
        torch.cat([s1.xyz, gp.xyz + transl]),
        torch.cat([R.features(s1), R.features(gp)]),
        torch.cat([R.opacity(s1), R.opacity(gp)]),
        torch.cat([torch.exp(s1.scaling), torch.exp(gp.scaling)]),
        torch.cat([quat_normalize(s1.rotation),
                   quat_normalize(gp.rotation) + rot_delta]),
        torch.cat([after["static_alive"], before["dyn_alive"]]),
        after["poses"]))
    return out


def step_ops(cfg: dict, tile_ops: float) -> float:
    """FP32 operations of one joint iteration: the tile compositors'
    (`tile_ops`, both renders, forward and backward) and, from shapes, two
    SSIMs, the Pearson terms and the motion basis."""
    from ..counts import step as C

    w, h, d = cfg["width"], cfg["height"], cfg["trainer"]["dynamic"]
    box = 128
    n_corr = int(0.5 * (h // box) * (w // box))
    pearson = C.pearson_ops(w * h) + 2 * n_corr * C.pearson_ops(box * box)
    t = cfg["frames"]
    motion = (C.mlp_ops(d["deform_netwidth"], d["num_basis"],
                        2 * d["deform_t_emb_multires"] + 1, 1 + 2 * t)
              + C.coefficient_ops(cfg["capacity"], d["num_basis"], 1 + t))
    return tile_ops + 2 * C.ssim_ops(w, h) + pearson + motion


def run(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, log=print) -> dict:
    """One run of a `joint` cell: set-up, the window, with `trace` the
    profiled iterations, then the reference over the followed iterations.
    `t_start` is the process's start on the `time.perf_counter` clock."""
    from ..check import correct

    params = cell["params"]
    t_build = time.perf_counter()
    session = Session(cfg, params, seed, device)
    t_warm = time.perf_counter()
    followed = session.warm_up()
    log(f"[joint] set-up: {t_build - t_start:.3f} s to the scene (imports, "
        f"the card), {t_warm - t_build:.3f} s scene, GT frames and trainer, "
        f"{time.perf_counter() - t_warm:.3f} s warm-up")
    log(f"[joint] warm-up to iteration {session.iteration - 1}; followed "
        f"iterations that dropped fragments: {followed.start.dropped} + "
        f"{followed.window.dropped}; profiles "
        f"{session.joint.static.fragment_profile} / "
        f"{session.joint.dyn_fragment_profile}")
    setup_s = time.perf_counter() - t_start
    w = session.window(seconds)
    ev = sorted(w["event_ms"])
    q = lambda p: ev[min(len(ev) - 1, int(p * len(ev)))]
    log(f"[joint] window: {w['iterations']} iterations to "
        f"{w['last_iteration']}, iteration_ms {w['iteration_ms']:.4f}, "
        f"event p50 {q(0.5):.4f} p95 {q(0.95):.4f} max {ev[-1]:.4f} ms, "
        f"failed {w['failed']} {w['failed_by']}, profiles {w['profiles']}")
    out = {"attempted": w["iterations"], "failed": w["failed"],
           "memory_peak_bytes": w["peak_bytes"],
           "end_to_end": {
               "iteration_ms": w["iteration_ms"],
               "iteration_ms_p95": _p95(w["event_ms"]),
               "peak_mem_gib": w["peak_bytes"] / 2**30,
               "setup_s": setup_s}}

    prof_data = None
    if trace:
        prof_data = profile(session, params["profiled"])
    session.close()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_start, ref_window = reference_stretches(
        cfg, params, seed, session.inputs, session.frames, followed, device)
    found = found_numbers(followed.start, followed.window, ref_start,
                          ref_window, session.inputs, followed.state,
                          w["failed"])
    limits = cell["limits"]
    log(f"[joint] program losses {followed.start.losses} "
        f"{followed.window.losses}; reference {ref_start.losses} "
        f"{ref_window.losses}")
    out["checks"] = {k: (v, limits.get(k), at)
                     for k, (v, at) in found.items()}
    out["correct"] = correct({k: v for k, (v, _) in found.items()}, limits)

    if prof_data is not None:
        tr, snaps, frames = prof_data
        ref = R.Reference(cfg["trainer"], cfg["width"], cfg["height"],
                          snaps[0]["unique_times"].to(device))
        from ..counts import tiles as K

        work = {"tile_fwd": [0.0, 0.0, 0.0], "tile_bwd": [0.0, 0.0, 0.0]}
        tile_ops = 0.0
        for k, fi in enumerate(frames):
            for rows, b in render_rows(cfg, ref, snaps[k], snaps[k + 1],
                                       session.frames[fi], device):
                for name, (nbytes, ops) in K.tile_work(
                        K.walk(rows, b)).items():
                    work[name][0] += nbytes
                    work[name][1] += ops
                    work[name][2] += K.bound_s(nbytes, ops)
                    tile_ops += ops
        tr.work = {k: tuple(v) for k, v in work.items()}
        tr.iteration_ms = w["iteration_ms"]
        tr.step_ops = step_ops(cfg, tile_ops / len(frames)) * len(frames)
        log(f"[joint] traced iterations: {tr.wall_s * 1e3 / tr.iterations:.4f}"
            f" ms each under the profiler, untraced {w['iteration_ms']:.4f}"
            f" ms; device busy {tr.busy_s:.6f} of {tr.wall_s:.6f} s; kernels"
            f" {tr.kernel_s}; tile work (bytes, ops, bound s) {tr.work}")
        out["trace"] = tr
    return out


def _p95(values) -> float:
    """The 95th percentile, linearly interpolated between order statistics."""
    v = sorted(values)
    x = 0.95 * (len(v) - 1)
    i = int(x)
    j = min(i + 1, len(v) - 1)
    return v[i] + (v[j] - v[i]) * (x - i)


def profile(session: Session, n: int):
    """Profile `n` iterations from a number = 1 mod 5 whose run has no
    densification (the next multiple of 100), each in a
    `port_bench.iteration` range ending in a synchronise; the render
    inputs are copied to the host between the ranges. Returns (Trace, the
    n + 1 snapshots, the frame index of each iteration)."""
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    from ..trace import ITERATION_RANGE, analyse

    while session.iteration % 5 != 1 or any(
            (session.iteration + k) % 100 == 0 for k in range(n)):
        session.step()
    first = session.params["first_iteration"]
    frames = [int(session.order[session.iteration + k - first])
              for k in range(n)]
    snaps = []
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            snaps.append(session.render_inputs())
            torch.cuda.synchronize()
            with record_function(ITERATION_RANGE):
                session.step()
                torch.cuda.synchronize()
        snaps.append(session.render_inputs())
    return analyse(prof), snaps, frames
