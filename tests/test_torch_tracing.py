"""The port's spans and counters (`utils/profiling.py`) on the CPU: off
while no profiler runs (the shared no-op, no `record_function`), and under
`torch.profiler` one tiny joint iteration of the kubric loss lists
(`configs/train/train_kubric_mrig.yaml` at 32x32, box_p 16, K 4) records
each layer's span under its parent, in one iteration, the counters equal
the step's own fragment numbers, and the numbers are bitwise those of the
same iteration unrecorded. `tools/profile_step` prints the layers' host ms
from the `spans.json` its trace writes."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from rodygs_tpu_torch.models import gaussians as G
from rodygs_tpu_torch.render.compact import fragment_capacity, split_profile
from rodygs_tpu_torch.tools import profile_step
from rodygs_tpu_torch.train import losses as L
from rodygs_tpu_torch.train import optim as O
from rodygs_tpu_torch.train import trainer_dynamic as TD
from rodygs_tpu_torch.train import trainer_joint as TJ
from rodygs_tpu_torch.train import trainer_static as TS
from rodygs_tpu_torch.utils import profiling as P

W, H = 32, 32
KUBRIC = Path(__file__).resolve().parents[1] / (
    "configs/train/train_kubric_mrig.yaml")
# rigidity (every 5th) and a poll (every 25th), no densification
ITERATION = 925


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_recorder():
    P.reset()
    yield
    P.reset()


class Recorded:
    """One joint iteration under the profiler: its metrics, trainer,
    recorder output and records, the profiler's event names, and the
    capacities both renders sorted."""

    def __init__(self):
        P.reset()
        self.joint, batch = tiny_joint()
        st = self.joint.static
        self.caps = (
            fragment_capacity(st.capacity(), st.fragment_profile),
            fragment_capacity(st.capacity() + G.capacity_of(
                self.joint.dynamic.state.store),
                self.joint.dyn_fragment_profile))
        self.bands = split_profile(st.fragment_profile)[1]
        with cpu_profile() as prof:
            self.m = self.joint.train_iteration(batch, batch, ITERATION)
        self.rec = P.recorded()
        self.records = list(P.RECORDER.records)
        self.keys = {e.key for e in prof.key_averages()}
        P.reset()


@pytest.fixture(scope="module")
def recorded_iteration():
    return Recorded()


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def kubric_losses():
    with open(KUBRIC) as f:
        trainer = yaml.safe_load(f)["trainer"]["params"]
    out = {}
    for stage in ("static", "dynamic"):
        lst = trainer[stage]["params"]["loss_config"]["params"][
            "loss_configs"]
        for term in lst:
            p = term.get("params") or {}
            if "box_p" in p:
                p["box_p"] = 16
            if "K" in p:
                p["K"] = 4
        out[stage] = lst
    return out


def tiny_joint():
    """The joint trainer on 120 static and 60 dynamic seeded points (born
    at t in {0, 0.5, 1}), and one frame of seeded GT."""
    rng = np.random.default_rng(5)
    f32 = lambda x: np.asarray(x, np.float32)
    static = G.from_point_cloud(
        f32(rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5], (120, 3))),
        f32(rng.uniform(0.1, 0.9, (120, 3))), sh_degree=1, capacity=128,
        device="cpu")
    dyn = G.from_point_cloud(
        f32(rng.uniform([-0.8, -0.5, 2.8], [0.8, 0.5, 3.8], (60, 3))),
        f32(rng.uniform(0.1, 0.9, (60, 3))), sh_degree=1, capacity=64,
        times=f32(rng.choice([0.0, 0.5, 1.0], 60)), device="cpu")
    poses = O.CameraPoses(torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2),
                          torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0]]))
    lists = kubric_losses()
    size = dict(image_width=W, image_height=H, sh_degree=1)
    st = TS.ThreeDGSTrainer(TS.StaticTrainerConfig(**size),
                            L.MultiLoss.from_config(lists["static"]), static,
                            poses, 3.0, device="cpu", seed=1)
    dt = TD.DynTrainer(
        TD.DynTrainerConfig(**size, deform_netwidth=32,
                            deform_t_emb_multires=6, num_basis=4),
        L.MultiLoss.from_config(lists["dynamic"]), dyn, 3.0, seed=2,
        device="cpu")
    joint = TJ.RoDyGSTrainer(st, dt, sh_up_start_iteration=15000)
    batch = TS.FrameBatch(
        gt_image=torch.tensor(f32(rng.uniform(0, 1, (H, W, 3)))),
        gt_depth=torch.tensor(f32(rng.uniform(1, 3, (H, W)))),
        motion_mask=None, frame_idx=1, time=torch.tensor(0.25),
        fovx=torch.tensor(0.9), fovy=torch.tensor(0.7))
    return joint, batch


def state_leaves(joint) -> list:
    return (O.tree_leaves(joint.static.state)
            + O.tree_leaves(joint.dynamic.state))


def test_off_returns_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    a = P.span("render")
    assert a is P.span("render") and a is not P.span("render", device=True)
    with a, P.span("fragment_sort", device=True):
        P.count("fragments", torch.tensor(5))

    @P.span("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert P.recorded() == {"iterations": 0, "spans": {}, "counters": {}}


def test_the_joint_iteration_records_each_layer(recorded_iteration):
    it = recorded_iteration
    rec = it.rec
    assert rec["iterations"] == 1
    parents = {(r.name, r.parent.name if r.parent else None)
               for r in it.records}
    for name, parent in (("iteration", None), ("render", "iteration"),
                         ("preprocess", "render"), ("binning", "render"),
                         ("expand", "render"), ("fragment_sort", "render"),
                         ("tile_fwd", "render"), ("loss", "iteration"),
                         ("loss.d_ssim", "loss"), ("loss.rigidity", "loss"),
                         ("rigidity_knn", "loss.rigidity"),
                         ("backward", "iteration"), ("tile_bwd", "backward"),
                         ("fragment_unsort", "backward"),
                         ("segsum", "backward"), ("optim", "iteration"),
                         ("poller", "iteration"), ("host_read", "poller"),
                         ("motion_mlp", "iteration")):
        assert (name, parent) in parents, (name, parent)
    assert {r.iteration for r in it.records} == {1}
    spans = rec["spans"]
    for name in ("render", "loss", "backward", "optim", "poller",
                 "fragment_sort", "fragment_unsort"):
        assert spans[name]["calls"] == 2, name
    assert spans["rigidity_knn"]["within"]["loss"] > 0
    # the profiler's own events carry the same names
    assert {"iteration", "render", "loss", "backward", "optim",
            "fragment_sort", "rigidity_knn"} <= it.keys
    assert it.m["dynamic"]["rigidity"] >= 0


def test_self_time_is_duration_less_children():
    with cpu_profile():
        with P.span("iteration"):
            with P.span("backward"):
                with P.span("a"):
                    pass
                with P.span("a"):
                    with P.span("c"):
                        pass

                seen = []

                def engine_thread():
                    with P.span("tile_bwd"):
                        seen.append(P.RECORDER.records[-1])

                t = threading.Thread(target=engine_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    recs = {}
    for r in P.RECORDER.records:
        recs.setdefault(r.name, []).append(r)
    assert seen[0].parent is recs["backward"][0]
    ns = lambda r: r.end - r.start
    spans = P.recorded()["spans"]
    for name, kids in (("iteration", ("backward",)),
                       ("backward", ("a", "tile_bwd")), ("a", ("c",))):
        child = sum(ns(r) for k in kids for r in recs[k]
                    if r.parent.name == name)
        total = sum(ns(r) for r in recs[name])
        assert spans[name]["self_host_ms"] == pytest.approx(
            (total - child) * 1e-6, abs=1e-9)
        assert spans[name]["host_ms"] == pytest.approx(total * 1e-6,
                                                       abs=1e-9)
    assert spans["c"]["within"] == pytest.approx({
        "a": ns(recs["c"][0]) * 1e-6, "backward": ns(recs["c"][0]) * 1e-6,
        "iteration": ns(recs["c"][0]) * 1e-6})


def test_counters_equal_the_steps_own_numbers(recorded_iteration):
    it = recorded_iteration
    m, counters = it.m, it.rec["counters"]
    assert it.bands == 1
    assert counters["fragments"] == (int(m["static"]["num_fragments"])
                                     + int(m["dynamic"]["num_fragments"]))
    assert counters["fragment_slots"] == sum(it.caps)
    assert counters["dropped_fragments"] == (int(m["static"]["dropped"])
                                             + int(m["dynamic"]["dropped"]))
    assert counters["host_reads"] == it.rec["spans"]["host_read"]["calls"]
    # two polls (static and dynamic), two reads each
    assert sum(r.name == "host_read" and r.parent.name == "poller"
               for r in it.records) == 4
    assert 0 < counters["fragments"] < counters["fragment_slots"]


def test_recording_leaves_the_numbers_bitwise_the_same(recorded_iteration):
    on = recorded_iteration
    joint, batch = tiny_joint()
    m = joint.train_iteration(batch, batch, ITERATION)
    assert P.recorded()["iterations"] == 0
    for stage in ("static", "dynamic"):
        for k, v in m[stage].items():
            assert torch.equal(v, on.m[stage][k]), (stage, k)
    for a, b in zip(state_leaves(joint), state_leaves(on.joint),
                    strict=True):
        assert torch.equal(a, b)


def test_profile_step_prints_the_layers_from_spans_json(tmp_path, capsys):
    args = profile_step.build_parser().parse_args([
        "--device", "cpu", "--width", "32", "--height", "32", "--n", "100",
        "--steps", "2", "--windows", "1", "--trace_dir", str(tmp_path)])
    profile_step.main(args)
    out = capsys.readouterr().out
    rec = json.loads((tmp_path / "spans.json").read_text())
    assert (tmp_path / "trace.json").is_file()
    assert rec["iterations"] == 2
    for name in ("render", "loss", "backward", "optim"):
        assert rec["spans"][name]["calls"] == 2
        assert f"{name} " in out
    assert "fragments" in rec["counters"] and "fragment fill" in out
