"""The port's multi-process layer on the CPU: `parallel/multihost.py` in a
world of two Gloo processes and as no-ops alone, resume files written by a
gauss-sharded world of the port and read by the JAX package (and the other
way round), and the train CLI as two processes (`--mesh data=2`): one
writer of the run's files, a log per process, a checkpoint and `--resume`.

Every spawned world and subprocess has its own deadline, so a process that
skips a collective fails its test instead of hanging the suite.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from rodygs_tpu.pipelines import build as jbuild
from rodygs_tpu_torch.parallel import multihost as MH
from rodygs_tpu_torch.parallel.dryrun import dryrun, run_world
from rodygs_tpu_torch.pipelines import train as ttrain_cli

import torch_parallel_ranks as ranks
from test_pipeline import scene_dir, train_config  # noqa: F401 (fixtures)

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT = 240.0
CLI_TIMEOUT = 300.0
GAUSS2 = {"data": 1, "gauss": 2, "tile": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread in this process (the ranks run on one each):
    the suite runs several worker processes on the same cores, where
    torch's OpenMP barriers wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# multihost functions
# --------------------------------------------------------------------------


def test_multihost_functions_in_a_two_process_world(tmp_path):
    out = run_world(ranks.multihost_calls, 2, (str(tmp_path),),
                    backend="gloo", timeout_s=WORLD_TIMEOUT)
    assert [r["primary"] for r in out] == [True, False]
    assert [r["index"] for r in out] == [0, 1]
    assert all(r["count"] == 2 and r["initialized"] for r in out)
    # every process adopts the primary's flag
    assert [r["flag"] for r in out] == [True, True]
    # the secondary waited for the primary's late write
    assert out[1]["waited"] > 0.2
    assert all("never not visible on process" in r["missing"] for r in out)
    for r in out:
        np.testing.assert_array_equal(r["psum"]["a"], [3.0, 10.0])
        np.testing.assert_array_equal(r["psum"]["b"][0], [3])
        assert r["psum"]["b"][0].dtype == np.int32
        np.testing.assert_array_equal(r["pmean"], [1.5, 5.0])
        np.testing.assert_array_equal(r["pmax"]["a"], [2.0, 10.0])
        np.testing.assert_array_equal(r["gathered"], [[0.0, 1.0], [0.0, 1.0]])
        np.testing.assert_array_equal(r["alive"], [True, True, False, True])
    # d(sum(w * gathered)) / d(block r) = the weights of block r, summed
    # over the ranks (each rank's loss holds the whole gathered tensor)
    np.testing.assert_array_equal(out[0]["gather_grad"], [[2.0], [6.0]])
    np.testing.assert_array_equal(out[1]["gather_grad"], [[4.0], [8.0]])


def test_dryrun_four_ranks():
    """The dry run on a 1 x 2 x 2 world: sharded densification of both
    stores, the forced escalation, the SH ramp, the resume round trip; the
    ranks agree on every loss."""
    out = dryrun(4, "gloo", "cpu", timeout_s=WORLD_TIMEOUT)
    assert out[0]["shape"] == {"data": 1, "gauss": 2, "tile": 2}
    for r in out:
        assert r["losses"] == out[0]["losses"]
        assert r["events"] == {"densify_static": 3, "densify_dynamic": 3}
        assert r["profile"][0] == 128 and r["profile"][1] != 128
        assert r["sh"] == 1 and r["moved"] > 0
        assert r["alive"] == out[0]["alive"]


def test_multihost_functions_alone(monkeypatch, tmp_path):
    for var in ("RODYGS_COORDINATOR", "RANK", "WORLD_SIZE",
                "RODYGS_DIST_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert MH.maybe_initialize_distributed() is False
    assert MH.is_primary() and MH.process_index() == 0
    assert MH.process_count() == 1
    assert MH.broadcast_flag(False) is False and MH.broadcast_flag(1) is True
    MH.barrier()
    MH.wait_for_path(tmp_path / "absent")   # returns: one process
    # torchrun's variables for a world of one are no multi-process launch
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert MH.maybe_initialize_distributed() is False
    # the explicit contract needs all three variables
    monkeypatch.setenv("RODYGS_COORDINATOR", "localhost:1234")
    with pytest.raises(KeyError):
        MH.maybe_initialize_distributed()
    # and a stated backend
    monkeypatch.setenv("RODYGS_NUM_PROCESSES", "2")
    monkeypatch.setenv("RODYGS_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="RODYGS_DIST_BACKEND"):
        MH.maybe_initialize_distributed()
    assert MH.dist_backend("gloo") == "gloo"
    with pytest.raises(ValueError, match="RODYGS_DIST_BACKEND"):
        MH.dist_backend("mpi")
    assert not torch.distributed.is_initialized()


def test_secondary_never_creates_the_logdir(tmp_path):
    import argparse

    args = argparse.Namespace(logdir=str(tmp_path), group="g", name="n",
                              seed=0, debug=False, resume=False)
    expect = tmp_path / "g" / "n_0" / "train"
    with pytest.raises(RuntimeError, match="timed out"):
        ttrain_cli.set_traindir(args, primary=False, timeout_s=0.2)
    assert not expect.exists()
    assert ttrain_cli.set_traindir(args, primary=True) == expect
    assert ttrain_cli.set_traindir(args, primary=False, timeout_s=1.0) == expect
    with pytest.raises(FileExistsError):
        ttrain_cli.set_traindir(args, primary=True)


# --------------------------------------------------------------------------
# resume files across the packages
# --------------------------------------------------------------------------


def _flat(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_same(jtree, ntree, what):
    jf, nf = _flat(jtree, what), _flat(ntree, what)
    assert sorted(jf) == sorted(nf), what
    for k in jf:
        np.testing.assert_array_equal(nf[k], jf[k], k)


def test_resume_files_cross_from_a_gauss_sharded_world(scene_dir,  # noqa: F811
                                                       train_config):
    """A 1 x 2 x 1 world writes one resume file in the global layout (the
    primary writes, every rank meets at the barrier); the JAX package's
    load_resume reads it, and the port's world reads the JAX package's
    file back, each rank into its own block."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "resume.ckpt")
        setup = dict(config=train_config, dirpath=str(scene_dir))
        out = run_world(ranks.resume_write_run, 2, (GAUSS2, setup, path),
                        backend="gloo", timeout_s=WORLD_TIMEOUT)
        kw = dict(dirpath=str(scene_dir), logdir=td, seed=3,
                  capacity_factor=2.0)
        jrun = jbuild.build_training_run(train_config, **kw)
        nxt, _ = jrun.joint.load_resume(path)
        assert nxt == 8
        _assert_same(jrun.joint.static.state, out[0]["static"], "static")
        _assert_same(jrun.joint.dynamic.state, out[0]["dynamic"], "dynamic")
        assert jrun.joint.static.active_sh_degree == 1

        # the other way: a JAX file, moved off the port's values first
        js = jrun.joint.static
        js.state = jax.tree.map(lambda x: x * 2 if x.dtype == np.float32
                                else x, js.state)
        js.active_sh_degree = 2
        jpath = os.path.join(td, "jax_resume.ckpt")
        jrun.joint.save_resume(jpath, 11, jax.random.key(3))
        back = run_world(ranks.resume_read_run, 2, (GAUSS2, setup, jpath),
                         backend="gloo", timeout_s=WORLD_TIMEOUT)
    for r in back:
        assert r["next"] == 12 and r["sh"] == 2
        _assert_same(js.state, r["static"], "static")
        _assert_same(jrun.joint.dynamic.state, r["dynamic"], "dynamic")
        blocks = np.split(np.asarray(js.state.store.params.xyz), 2)
        np.testing.assert_array_equal(r["block_xyz"], blocks[r["gauss"]])


# --------------------------------------------------------------------------
# the train CLI as two processes
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_world(args, n=2):
    """The train CLI as n processes over the explicit RODYGS_* contract;
    their (exit codes, outputs), every process ended by the deadline."""
    port = _free_port()
    procs = []
    for i in range(n):
        env = dict(os.environ, RODYGS_COORDINATOR=f"127.0.0.1:{port}",
                   RODYGS_NUM_PROCESSES=str(n), RODYGS_PROCESS_ID=str(i),
                   RODYGS_DIST_BACKEND="gloo", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rodygs_tpu_torch.pipelines.train", *args],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CLI_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def test_train_cli_two_processes(scene_dir, train_config, tmp_path):  # noqa: F811
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.dump(train_config))
    args = ["-d", str(scene_dir), "-b", str(cfg), "-g", "grp", "-n", "run",
            "-l", str(tmp_path / "logs"), "-s", "1", "--capacity_factor",
            "2.0", "--checkpoint_every", "3", "--device", "cpu", "--mesh",
            "data=2", "trainer.params.log_freq=3"]
    rcs, outs = _train_world(args + ["--num_iterations", "6"])
    assert rcs == [0, 0], outs
    train = tmp_path / "logs" / "grp" / "run_1" / "train"
    for name in ("train.log", "train.p1.log", "args.yaml", "config.yaml",
                 "static_last.ckpt", "dynamic_last.ckpt", "resume.ckpt"):
        assert (train / name).exists(), name
    assert sorted(p.name for p in train.glob("*.yaml")) == ["args.yaml",
                                                            "config.yaml"]
    assert (train / "code" / "rodygs_tpu_torch").is_dir()
    logs = [(train / n).read_text() for n in ("train.log", "train.p1.log")]
    for log, coords in zip(logs, ("'data': 0", "'data': 1")):
        assert "[6/6]" in log and coords in log, log
    # both ranks log the same losses: one model, the mean of two frames
    lines = [[ln.split("] ", 1)[1].split(" step p50")[0]
              for ln in log.splitlines() if "[6/6]" in ln] for log in logs]
    assert lines[0] == lines[1]

    rcs, outs = _train_world(args + ["--num_iterations", "8", "--resume"])
    assert rcs == [0, 0], outs
    logs = [(train / n).read_text() for n in ("train.log", "train.p1.log")]
    for log in logs:
        assert "resumed from" in log and "at iteration 7" in log
        assert log.count("checkpoints saved") == 2
