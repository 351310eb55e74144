"""Parity of `rodygs_tpu_torch.tools.bench` with `bench.py` at the repository
root, on the CPU at a small size (64x48, 300 gaussians in 512 slots, 3
frames): the scene (store, poses, GT frames, trainer config), the window
rule and the returned dict under the same scripted clock, the first three
warm-up steps' losses, and the JSON line the tool prints, also when its
1080p point fails.

`bench.py` imports JAX inside its functions only; it runs here on the CPU
(tests/conftest.py), its Pallas kernels in interpret mode.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench as jbench  # noqa: E402  (the JAX script)
from rodygs_tpu.train import trainer_static as jts  # noqa: E402
from rodygs_tpu_torch import convert, kernels  # noqa: E402
from rodygs_tpu_torch.tools import bench as tbench  # noqa: E402
from rodygs_tpu_torch.train import trainer_static as tts  # noqa: E402

SMALL = dict(W=64, H=48, N=300, capacity=512, n_frames=3)
JSON_KEYS = {"metric", "value", "unit", "vs_baseline", "workloads",
             "host_load1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: the suite's worker processes share the cores
    (tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stop(Exception):
    """Raised by a patched train_iteration to end `measure` early."""


def recording(monkeypatch, module, calls, n_run=0, n_record=1, result=None):
    """Patch `module.ThreeDGSTrainer.train_iteration`: record (trainer,
    batch, iteration, metrics) of the first `n_record` calls, running the
    real step for the first `n_run` of them, then raise Stop. With
    `result` set, every call returns it instead and nothing stops."""
    real = module.ThreeDGSTrainer.train_iteration

    def patched(self, batch, iteration, *rng):
        if result is not None:
            return result
        if len(calls) == n_record:
            raise Stop
        m = real(self, batch, iteration, *rng) if len(calls) < n_run else None
        calls.append((self, batch, iteration, m))
        return m

    monkeypatch.setattr(module.ThreeDGSTrainer, "train_iteration", patched)


def test_scene_matches(monkeypatch):
    calls = []
    recording(monkeypatch, jts, calls, n_record=SMALL["n_frames"])
    with pytest.raises(Stop):
        jbench.measure(**SMALL, n_windows=1, iters_per_window=1)
    jtr = calls[0][0]
    assert [c[2] for c in calls] == [910, 911, 912]
    work = tbench.build_workload(**SMALL, device="cpu")

    want = jtr.state.store
    got = convert.store_to_numpy(work.trainer.state.store)
    for name in want.params._fields:
        np.testing.assert_array_equal(
            got["params"][name], np.asarray(getattr(want.params, name)),
            err_msg=name)
    for key in ("alive", "time", "time_ind"):
        np.testing.assert_array_equal(got[key], np.asarray(getattr(want, key)),
                                      err_msg=key)
    for name in ("q_c2w", "t_c2w"):
        np.testing.assert_array_equal(
            getattr(work.trainer.state.poses, name).numpy(),
            np.asarray(getattr(jtr.state.poses, name)), err_msg=name)
    for i, (_, batch, _, _) in enumerate(calls):
        np.testing.assert_allclose(work.gts[i].numpy(),
                                   np.asarray(batch.gt_image), atol=2e-5)
        tb = work.batch_for(i)
        assert tb.frame_idx == int(batch.frame_idx) == i
        assert float(tb.fovx) == float(batch.fovx) == np.float32(tbench.FOV)
    assert dataclasses.asdict(work.trainer.cfg) == dataclasses.asdict(jtr.cfg)
    assert work.trainer.spatial_lr_scale == jtr.spatial_lr_scale == 4.0


class ScriptedClock:
    """A clock module whose every reading is the next of `readings`."""

    def __init__(self, readings):
        self.readings = list(readings)

    def time(self):
        return self.readings.pop(0)

    perf_counter = time


def window_clock(step_s, iters):
    """Start and end readings of windows whose steps take `step_s`."""
    out, t = [], 100.0
    for s in step_s:
        out += [t, t + s * iters]
        t += s * iters + 0.5
    return out


@pytest.mark.parametrize("step_s", [
    [0.030, 0.0312, 0.0305, 0.045, 0.050],      # a slow tail
    [0.040, 0.020, 0.0405, 0.039, 0.0401],      # a lone fast window
], ids=["slow_tail", "lone_fast"])
def test_window_rule_matches(monkeypatch, step_s):
    iters = 4
    recording(monkeypatch, jts, [], result={"loss": jnp.zeros(())})
    recording(monkeypatch, tts, [], result={"loss": torch.zeros(())})
    monkeypatch.setattr(jbench, "time",
                        ScriptedClock(window_clock(step_s, iters)))
    monkeypatch.setattr(tbench, "time",
                        ScriptedClock(window_clock(step_s, iters)))
    kw = dict(SMALL, n_windows=len(step_s), iters_per_window=iters)
    want = jbench.measure(**kw)
    got = tbench.measure(**kw, device="cpu")
    assert set(got) == set(want)
    for key in ("step_ms", "windows_ms", "n_steady", "mpix_per_s"):
        assert got[key] == want[key], key
    steady = [s for s in step_s if s <= 1.1 * min(step_s)]
    assert got["n_steady"] == len(steady) < len(step_s)
    assert tbench.steady_median(step_s) == (float(np.median(steady)),
                                            len(steady))


def test_first_steps_match(monkeypatch):
    jcalls, tcalls = [], []
    recording(monkeypatch, jts, jcalls, n_run=3, n_record=3)
    recording(monkeypatch, tts, tcalls, n_run=3, n_record=3)
    for fn, kw in ((jbench.measure, {}), (tbench.measure, {"device": "cpu"})):
        with pytest.raises(Stop):
            fn(**SMALL, n_windows=1, iters_per_window=1, **kw)
    assert [c[2] for c in jcalls] == [c[2] for c in tcalls] == [910, 911, 912]
    want = [float(c[3]["loss"]) for c in jcalls]
    got = [float(c[3]["loss"]) for c in tcalls]
    assert all(np.isfinite(want)) and want[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)


def jax_line(monkeypatch, capsys, workload):
    """The last line `bench.py`'s main prints, its measurements replaced by
    `workload`."""
    monkeypatch.setenv("RODYGS_BENCH_SKIP_1080P", "1")
    monkeypatch.setattr(jbench, "measure", lambda **kw: dict(workload))
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_prints_the_line(monkeypatch, capsys):
    monkeypatch.setenv("RODYGS_BENCH_SKIP_1080P", "1")
    monkeypatch.setattr(tbench, "HEADLINE", dict(SMALL, n_windows=2,
                                                 iters_per_window=2))
    points = {}
    assert tbench.main(["--device", "cpu"], points=points) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "cpu"
    line = json.loads(lines[-1])
    assert set(line) == JSON_KEYS
    assert line["metric"] == "train_step_fwd_bwd_mpix_per_s"
    work = line["workloads"]["64x48_0k"]
    assert list(line["workloads"]) == ["64x48_0k"]
    assert line["value"] == work["mpix_per_s"] > 0
    assert line["vs_baseline"] == round(work["mpix_per_s"] / 3.5, 3)
    assert work["n_steady"] >= 1 and len(work["windows_ms"]) == 2
    assert list(points) == ["64x48_0k"]
    assert points["64x48_0k"].result == work
    assert set(points["64x48_0k"].launches) == set(kernels.LAUNCHES)
    assert set(jax_line(monkeypatch, capsys, work)) == set(line)


def test_failed_1080p_point_exits_non_zero(monkeypatch, capsys):
    monkeypatch.delenv("RODYGS_BENCH_SKIP_1080P", raising=False)
    headline = {"mpix_per_s": 5.0, "step_ms": 52.43, "windows_ms": [52.4],
                "n_steady": 1, "fragment_profile": "lean"}
    seen = []

    def run_point(**kw):
        seen.append(kw)
        if kw["W"] == 1920:
            raise RuntimeError("forced failure")
        return tbench.Point(dict(headline), None, None, {})

    monkeypatch.setattr(tbench, "run_point", run_point)
    assert tbench.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert [(k["W"], k["H"], k["N"], k["capacity"]) for k in seen] == [
        (512, 512, 100_000, 131072), (1920, 1080, 240_000, 262144)]
    assert line["workloads"] == {
        "512x512_100k": headline,
        "1920x1080_240k": {"error": repr(RuntimeError("forced failure"))}}
    assert line["value"] == 5.0 and "1080p point failed" in out.err
    assert set(line) == set(jax_line(monkeypatch, capsys, headline))


def test_no_card_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tbench.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
