"""The controls of a training cell's comparison: the reference put in the
program's place, computed one precision lower (TF32 for the configuration's
FP32 with TF32 off), and the reference with a planted fault. Each is
compared with the reference exactly as a run compares the program, on the
cell's own scene and from the same program state, and judged by the same
`check.correct` against the cell's limits, so the readings are the upper
ends its limits are set below.

    python3 port_bench/control.py --workload <cell> --seeds 11 12 13
        [--faults]

The lower precision is the card's TF32 for every matrix product and
convolution. Faults (`--faults`): `half_batch`, the image and depth terms
over the top half of the frame's rows only, the mean over those. A step
that returns its state unchanged reads 1 by `change_gap` and needs no run.
The program runs its warm-up once a seed, for the state the window's
stretch starts from; its window does not run. Prints one line per seed and
control with the numbers and `correct`; exits 1 if any control reads
correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from port_bench.check import correct  # noqa: E402
from port_bench.reference import losses as RL  # noqa: E402
from port_bench.traffic import joint as J  # noqa: E402


@contextlib.contextmanager
def lower_precision():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def half_batch():
    """The image and depth terms see the top half of the rows only."""
    saved = dict(RL._LOSS_REGISTRY)

    def halved(fn):
        def term(ctx, **kw):
            h = ctx["pred_img"].shape[0] // 2
            ctx = dict(ctx)
            for k in ("pred_img", "gt_img", "pred_depth", "gt_depth"):
                ctx[k] = ctx[k][:h]
            return fn(ctx, **kw)
        return term

    for k in ("SSIMLoss", "L1Loss", "GlobalPearsonDepthLoss",
              "LocalPearsonDepthLoss"):
        RL._LOSS_REGISTRY[k] = halved(saved[k])
    try:
        yield
    finally:
        RL._LOSS_REGISTRY.clear()
        RL._LOSS_REGISTRY.update(saved)


def readings(cell: dict, cfg: dict, seed: int, device, controls) -> dict:
    """{control: {number: value}} against the reference on one seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = cell["params"]
    session = J.Session(cfg, params, seed, device)
    followed = session.warm_up()
    session.close()
    inputs, frames = session.inputs, session.frames
    ref = J.reference_stretches(cfg, params, seed, inputs, frames, followed,
                                device)
    out = {}
    for name, ctx in controls.items():
        with ctx():
            ctl = J.reference_stretches(cfg, params, seed, inputs, frames,
                                        followed, device)
        # no program window runs: its count of failed iterations is 0
        found = J.found_numbers(*ctl, *ref, inputs, followed.state, 0)
        out[name] = {k: v for k, (v, _) in found.items()}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args(argv)
    cell = json.loads((BENCH / "workloads" /
                       f"{args.workload}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                     .read_text())
    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = {"tf32": lower_precision}
    if args.faults:
        controls["half_batch"] = half_batch
    passed = []
    for seed in args.seeds:
        for name, nums in readings(cell, cfg, seed, device,
                                   controls).items():
            ok = correct(nums, cell["limits"])
            if ok:
                passed.append((seed, name))
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": name, **nums, "correct": ok}),
                  flush=True)
    if passed:
        print(f"[control] controls that read correct: {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
