"""CPU tests of the benchmark harness (not part of the repository's tier-1
suite: run them with `python -m pytest port_bench/tests -q`, ~4 minutes on
four threads). The cells run at a tiny size here, with the port's plain
versions of its kernels in place of the CUDA ones, the card's events and
synchronise replaced by the host clock (`host_as_card`), and TF32 emulated
by rounding each product's operands (`TF32Operands`)."""

from __future__ import annotations

import ast
import contextlib
import json
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch
from torch.overrides import TorchFunctionMode

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

from port_bench import control as CTL  # noqa: E402
from port_bench import run as RUN  # noqa: E402
from port_bench.check import correct  # noqa: E402
from port_bench.counts import tiles as K  # noqa: E402
from port_bench.guard import forbidden_modules  # noqa: E402
from port_bench.reference import render as RR  # noqa: E402
from port_bench.traffic import joint as J  # noqa: E402

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
FORBIDDEN_IN_REFERENCE = ("rodygs_tpu_torch", "rodygs_tpu", "jax", "jaxlib")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


class HostEvent:
    """A CUDA event's part the harness uses, on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


@pytest.fixture(autouse=True)
def host_as_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit mantissa;
    the gradient passes through unchanged."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    out = torch.where(torch.isfinite(x), bits.view(torch.float32), x)
    return x + (out - x).detach()


class TF32Operands(TorchFunctionMode):
    """Every float32 matrix product with its operands rounded to TF32, as
    the card's tensor cores take them."""

    PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.addmm,
                torch.einsum, torch.Tensor.__matmul__, torch.Tensor.matmul,
                torch.Tensor.mm, torch.Tensor.bmm, torch.nn.functional.linear}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            rnd = lambda a: tf32_round(a) if isinstance(a, torch.Tensor) else a
            if func in (torch.einsum, torch.addmm):
                args = (args[0],) + tuple(rnd(a) for a in args[1:])
            else:
                args = tuple(rnd(a) for a in args)
        return func(*args, **kwargs)


def tiny(name: str):
    """The cell at 256x192, 4 frames, 300 gaussians in 512 slots: the first
    stretch (910-912), the stretch before the window (913-915) and a window
    from 916."""
    cell, cfg = RUN.load_cell(BENCH, name)
    cfg = dict(cfg, width=256, height=192, frames=4, num_limit_points=300,
               capacity=512)
    cell = dict(cell, params=dict(cell["params"], window_first=916,
                                  profiled=2))
    return cell, cfg


def run_tiny(name: str, seed: int, trace: bool = False) -> dict:
    cell, cfg = tiny(name)
    return J.run(cell, cfg, seed, 0.5, trace, torch.device("cpu"), 0.0,
                 log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_and_config_load_by_name(name):
    cell, cfg = RUN.load_cell(BENCH, name)
    assert (BENCH / "traffic" / f"{cell['traffic']}.py").is_file()
    gaps = {f"{s}.{k}" for s in ("start", "window")
            for k in ("loss_gap", "grad_gap", "change_gap")}
    assert cfg["width"] > 0 and set(cell["limits"]) == gaps | {
        "followed.dropped", "window.failed"}
    assert cell["limits"]["followed.dropped"] == 0
    assert cell["limits"]["window.failed"] == 0


def test_a_new_cell_file_is_found_without_code(tmp_path):
    copy = tmp_path / "port_bench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns(".cache"))
    cell, _ = RUN.load_cell(BENCH, CELLS[0])
    (copy / "workloads" / "added.cell.json").write_text(
        json.dumps(dict(cell, why="added as a file")))
    found, cfg = RUN.load_cell(copy, "added.cell")
    assert found["why"] == "added as a file" and cfg["frames"] > 0
    with pytest.raises(FileNotFoundError):
        RUN.load_cell(copy, "no.such.cell")


def test_per_layer_metrics_have_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        reader = RUN.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"])


def test_jax_guard_compares_whole_top_level_names():
    assert forbidden_modules(["rodygs_tpu_torch.x", "rodygs_tpu_torch",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["rodygs_tpu.x"]) == ["rodygs_tpu.x"]
    assert forbidden_modules(["jax", "jaxlib.xla", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla"]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN_IN_REFERENCE, (
                    path, n)
    code = ("import sys; sys.path.insert(0, %r); import importlib, pkgutil; "
            "import port_bench.reference as R; "
            "[importlib.import_module('port_bench.reference.' + m.name) "
            "for m in pkgutil.iter_modules(R.__path__)]; "
            "print(sorted({k.split('.')[0] for k in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & set(FORBIDDEN_IN_REFERENCE)


def test_reference_render_equals_the_program_on_the_cpu():
    from port_bench import scene as S
    from port_bench.reference import step as R
    from rodygs_tpu_torch.render.camera import make_camera
    from rodygs_tpu_torch.render.rasterize import render

    _, cfg = tiny(CELLS[0])
    sc = S.build(cfg, 5, torch.device("cpu"))
    p = sc.static
    frame = sc.frames[1]
    cam = R._camera(sc.poses, frame)
    ref = RR.render(p.xyz, R.features(p), R.opacity(p), torch.exp(p.scaling),
                    p.rotation, cam, 0, cfg["width"], cfg["height"],
                    sc.static_alive)
    prog = render(p.xyz, R.features(p), R.opacity(p), torch.exp(p.scaling),
                  p.rotation, make_camera(cam.q_c2w, cam.t_c2w, cam.fovx,
                                          cam.fovy, device="cpu"), 0,
                  cfg["width"], cfg["height"], alive=sc.static_alive,
                  fragment_profile="huge", include_normal=False)
    for k in ("rendered_image", "rendered_depth", "rendered_alpha"):
        assert torch.equal(ref[k], prog[k]), k


@pytest.mark.parametrize("name", CELLS)
def test_one_run_agrees_with_the_reference(name):
    res = run_tiny(name, 2**31 + 17)
    assert res["correct"] and res["failed"] == 0
    for name, (value, limit, _) in res["checks"].items():
        if name.endswith("_gap"):
            assert value <= 1e-6 < limit, name
        else:
            assert value == limit == 0, name


def test_correct_needs_every_number_at_or_under_its_limit():
    limits = {"a": 1e-4, "n": 0}
    assert correct({"a": 1e-4, "n": 0}, limits)
    assert not correct({"a": 2e-4, "n": 0}, limits)
    assert not correct({"a": 0.0, "n": 1}, limits)
    assert not correct({"a": float("nan"), "n": 0}, limits)
    assert not correct({"a": 0.0}, limits)


def test_traced_run_reads_its_counts():
    res = run_tiny(CELLS[0], 23, trace=True)
    tr = res["trace"]
    assert tr.iterations == 2 and tr.work["tile_fwd"][1] > 0
    assert RUN.metric_reader("mfu").read(tr) > 0
    assert RUN.metric_reader("roofline.tile_fwd").read(tr) is None


def test_counts_on_a_hand_counted_tile():
    """One 16x16 tile, five fragments of opacity 0.95 with a flat falloff
    (conic 0: alpha 0.95 at every pixel). Transmittance 0.05, 0.0025,
    1.25e-4, then the fourth would take it below 1e-4: each pixel takes
    three, rejects the fourth (the stop) and never evaluates the fifth."""
    rows = torch.zeros((10, 5))
    rows[0:2] = 8.0
    rows[5] = 0.95
    rows[9] = torch.arange(1.0, 6.0)
    b = RR.Binning(gid=torch.arange(5), tile_starts=torch.tensor([0]),
                   tile_counts=torch.tensor([5]), tiles_x=1, tiles_y=1)
    w = K.walk(rows, b)
    assert (w["contrib"], w["rejected"], w["needed"]) == (768, 256, 4)
    for n in w["warp_pairs"].values():
        assert n == {"block_walk": 32, "kept_lanes": 1024}
    work = K.tile_work(w)
    assert work["tile_fwd"] == (160 + 8 + 5120, 31 * 768 + 17 * 256)
    assert work["tile_bwd"] == (160 + 8 + 2 * 5120 + 160,
                                76 * 768 + 17 * 256)


@contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def test_a_step_that_keeps_its_state_is_not_correct():
    from rodygs_tpu_torch.train import trainer_dynamic, trainer_static

    with patched(trainer_static, "apply_static_update",
                 lambda cfg, s, state, *a: state), \
            patched(trainer_dynamic.DynTrainer, "apply_update",
                    lambda self, state, *a: state):
        res = run_tiny(CELLS[0], 31)
    assert not res["correct"]
    for stretch in ("start", "window"):
        assert res["checks"][f"{stretch}.change_gap"][0] == pytest.approx(
            1.0)


@contextlib.contextmanager
def halved_program_terms(from_iteration: int = 0):
    """The program's image and depth terms over the top half of the rows
    only, in the iterations from `from_iteration` on."""
    from rodygs_tpu_torch.train import losses as PL
    from rodygs_tpu_torch.train.trainer_joint import RoDyGSTrainer

    saved = dict(PL._LOSS_REGISTRY)
    train_iteration = RoDyGSTrainer.train_iteration

    def halved(fn):
        def term(ctx, **kw):
            h = ctx["pred_img"].shape[0] // 2
            ctx = dict(ctx)
            for k in ("pred_img", "gt_img", "pred_depth", "gt_depth"):
                ctx[k] = ctx[k][:h]
            return fn(ctx, **kw)
        return term

    def iteration(self, sb, db, it):
        names = ("SSIMLoss", "L1Loss", "GlobalPearsonDepthLoss",
                 "LocalPearsonDepthLoss")
        PL._LOSS_REGISTRY.update(
            {k: halved(saved[k]) if it >= from_iteration else saved[k]
             for k in names})
        return train_iteration(self, sb, db, it)

    try:
        with patched(RoDyGSTrainer, "train_iteration", iteration):
            yield
    finally:
        PL._LOSS_REGISTRY.update(saved)


def test_half_the_batch_left_out_is_not_correct():
    with halved_program_terms():
        res = run_tiny(CELLS[0], 37)
    assert not res["correct"]


def test_a_fault_after_the_first_stretch_is_not_correct():
    """A fault from iteration 913 on, the profile the window runs (as a
    poller's band split would be): the first stretch holds, the stretch
    before the window does not."""
    with halved_program_terms(from_iteration=913):
        res = run_tiny(CELLS[0], 43)
    checks = res["checks"]
    assert checks["start.loss_gap"][0] <= 1e-6
    assert checks["window.loss_gap"][0] > checks["window.loss_gap"][1]
    assert not res["correct"]


def test_an_image_dropped_in_the_window_is_not_correct():
    """A window iteration that drops fragments renders a wrong image."""
    from rodygs_tpu_torch.train.trainer_joint import RoDyGSTrainer

    train_iteration = RoDyGSTrainer.train_iteration

    def iteration(self, sb, db, it):
        m = train_iteration(self, sb, db, it)
        if it == 916:
            m["dynamic"]["dropped"] = torch.tensor(7)
        return m

    with patched(RoDyGSTrainer, "train_iteration", iteration):
        res = run_tiny(CELLS[0], 47)
    assert res["failed"] == 1 and not res["correct"]
    assert res["checks"]["window.failed"][:2] == (1, 0)


def test_the_lower_precision_control_is_not_correct():
    cell, cfg = tiny(CELLS[0])
    got = CTL.readings(cell, cfg, 41, torch.device("cpu"),
                       {"tf32": TF32Operands, "half_batch": CTL.half_batch})
    for control, nums in got.items():
        assert not correct(nums, cell["limits"]), (control, nums)
