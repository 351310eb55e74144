"""The readers of the program's spans and counters (`port_bench/spans.py`
and the six metrics on it) on a stub recorder: each reads its number, and
None where the program has no recorder (as before it had one), recorded no
iteration, counted other iterations than the trace, or raises."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH.parent))

from port_bench import run as RUN  # noqa: E402
from rodygs_tpu_torch.utils import profiling  # noqa: E402

METRICS = ("host_ms.render", "host_ms.loss", "host_ms.backward",
           "host_ms.optim", "sort_ms", "fragment_fill")


def span(host_ms, device_ms=None, within=None, calls=2):
    return {"calls": calls, "host_ms": host_ms, "self_host_ms": host_ms,
            "device_ms": device_ms, "within": within or {}}


STUB = {
    "iterations": 2,
    "spans": {
        "iteration": span(400.0, calls=2),
        "render": span(60.0, calls=4),
        "loss": span(90.0, calls=4),
        "rigidity_knn": span(20.0, device_ms=150.0, calls=1,
                             within={"loss": 20.0, "loss.rigidity": 20.0}),
        "motion_mlp": span(4.0, calls=6, within={"loss": 1.0}),
        "backward": span(100.0, calls=4),
        "optim": span(30.0, calls=4),
        "fragment_sort": span(2.0, device_ms=3.0, calls=4),
        "fragment_unsort": span(1.0, device_ms=1.0, calls=4),
    },
    "counters": {"fragments": 300, "fragment_slots": 400,
                 "dropped_fragments": 0},
}
EXPECTED = {"host_ms.render": 30.0, "host_ms.loss": (90.0 - 21.0) / 2,
            "host_ms.backward": 50.0, "host_ms.optim": 15.0,
            "sort_ms": 2.0, "fragment_fill": 75.0}


def readers():
    return {name: RUN.metric_reader(name) for name in METRICS}


@pytest.fixture
def stub(monkeypatch):
    def use(record):
        def recorded():
            if isinstance(record, Exception):
                raise record
            return record
        monkeypatch.setattr(profiling, "recorded", recorded)
    return use


def test_each_reader_reads_the_stub(stub):
    stub(STUB)
    trace = SimpleNamespace(iterations=2)
    for name, reader in readers().items():
        assert reader.read(trace) == pytest.approx(EXPECTED[name]), name


@pytest.mark.parametrize("record", [
    dict(STUB, iterations=3),
    dict(STUB, iterations=0),
    dict(STUB, spans={k: v for k, v in STUB["spans"].items()
                      if k != "iteration"}),
    {"iterations": 2, "spans": {"iteration": span(1.0)}, "counters": {}},
    RuntimeError("the recorder failed"),
    {"unexpected": "layout"},
])
def test_nothing_to_read_is_none(stub, record):
    stub(record)
    trace = SimpleNamespace(iterations=2)
    for name, reader in readers().items():
        assert reader.read(trace) is None, name


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "recorded")
    trace = SimpleNamespace(iterations=2)
    for name, reader in readers().items():
        assert reader.read(trace) is None, name


def test_the_program_recorder_feeds_the_readers():
    import torch

    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("iteration"):
                with profiling.span("render"):
                    profiling.count("fragments", torch.tensor(3))
                    profiling.count("fragment_slots", 4)
        rd = readers()
        trace = SimpleNamespace(iterations=1)
        assert rd["host_ms.render"].read(trace) > 0
        assert rd["fragment_fill"].read(trace) == 75.0
        assert rd["sort_ms"].read(trace) is None
    finally:
        profiling.reset()
