"""Run one cell of the benchmark once, in this process, on this machine.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is `port_bench/workloads/<cell>.json`; it names its configuration
(`port_bench/configs/<config>.json`) and its traffic kind
(`port_bench/traffic/<kind>.py`, whose `run` drives the program). With
`--trace 0` the result carries the cell's end-to-end metrics of
`BENCHMARK.json`, with `--trace 1` its per-layer metrics, each read by
`port_bench/metrics/<metric>.py` from the traced run. The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`: each
number compared beside its limit). Exits 2 without printing a result when
there is no card, too few cards, no program to measure, or when a module of
JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def process_start() -> float:
    """The process's start on the `time.perf_counter` clock."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.perf_counter() - (uptime - started)


T_START = process_start()
# every cache the program or PyTorch keeps lives at a fixed path inside the
# checkout (the CUDA kernels build into rodygs_tpu_torch/_build/)
os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench_dir: Path, name: str) -> tuple[dict, dict]:
    """The cell `workloads/<name>.json` and the configuration it names."""
    cell = load_json(bench_dir / "workloads" / f"{name}.json")
    return cell, load_json(bench_dir / "configs" / f"{cell['config']}.json")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, group: str, cell: str) -> list[dict]:
    return [m for m in bench[group]
            if cell in m.get("workloads", [cell])]


def card_and_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        smi = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"
    return smi.stdout.strip()


def fail(msg: str) -> int:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    try:
        cell, cfg = load_cell(BENCH, args.workload)
    except FileNotFoundError as e:
        return fail(f"no cell {args.workload!r}: {e}")
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: nothing to measure")
    if torch.cuda.device_count() < chips:
        return fail(f"{torch.cuda.device_count()} CUDA devices, the cell "
                    f"asks for {chips}")
    try:
        importlib.import_module("rodygs_tpu_torch")
    except ImportError as e:
        return fail(f"the program is not here: {e!r}")
    from port_bench.guard import forbidden_modules

    print(f"[port_bench] card: {card_and_power_limit()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr,
          flush=True)
    traffic = importlib.import_module(f"port_bench.traffic.{cell['traffic']}")
    device = torch.device("cuda", 0)
    res = traffic.run(cell, cfg, args.seed, args.seconds, bool(args.trace),
                      device, T_START,
                      log=lambda m: print(m, file=sys.stderr, flush=True))

    found = forbidden_modules(sys.modules)
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {found}")

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips,
                   "memory_peak_bytes": int(res["memory_peak_bytes"])}
    metrics = {}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_info}
    if args.trace:
        tr = res["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.wall_s
        for m in cell_metrics(bench, "per_layer", args.workload):
            value = metric_reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    else:
        for m in cell_metrics(bench, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    print(f"[port_bench] {time.perf_counter() - T_START:.1f} s since the "
          f"process started", file=sys.stderr, flush=True)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim, _) in res["checks"].items()}
    for k, (v, lim, at) in res["checks"].items():
        print(f"{k} {v!r} limit {lim!r} ({at})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
