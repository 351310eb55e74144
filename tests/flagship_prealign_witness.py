"""The flagship pose pre-alignment of the JAX script and of the port, side by
side on the CPU: does the ladder move the ATE the same way in both?

    JAX_PLATFORMS=cpu python tests/flagship_prealign_witness.py \
        --out_dir DIR [--width 240 --height 136 --n 30000 --steps 25]

Runs `scripts/flagship_1080p.py` (the JAX package) and
`rodygs_tpu_torch.tools.flagship_1080p` (`--device cpu`), each in a process
of its own, with the same flags: pose noise 0.5 deg / 0.025,
`--pose_prealign --prealign_steps STEPS --motion_masks`, one joint
iteration. Both draw the same scene and the same noise from
`default_rng(13)`. Writes `jax.json` and `torch.json` (each tool's result)
and the logs into DIR, and prints each side's ATE before and after the
pre-alignment, its retry decisions and its per-view losses. The JAX side
runs with its persistent compile cache switched off, so nothing is written
outside DIR, and prints each view's pre-alignment as the port does. The
JAX package's kernels run in Pallas interpret mode here: at the default
size its side took 5,569 s and the port's 1,027 s on 8 CPU cores. Width
and height must be multiples of 4 (the ladder pools by 4).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# the JAX script run as __main__, with `enable_persistent_compile_cache` (a
# cache under /tmp) made a no-op first
_JAX_SIDE = """
import runpy, sys
import rodygs_tpu.utils.profiling as P
P.enable_persistent_compile_cache = lambda *a, **k: None
runpy.run_path({script!r}, run_name="__main__")
"""


def flags(args, out: Path, state: Path) -> list[str]:
    return ["--width", str(args.width), "--height", str(args.height),
            "--n", str(args.n), "--iters", "1", "--log_every", "1",
            "--pose_noise_rot_deg", "0.5", "--pose_noise_trans", "0.025",
            "--pose_prealign", "--prealign_steps", str(args.steps),
            "--motion_masks", "--allow_drops", "--out", str(out),
            "--state_dir", str(state)]


def run_side(name: str, cmd: list[str], out_dir: Path, env: dict) -> dict:
    t0 = time.time()
    with open(out_dir / f"{name}.log", "w") as logf:
        rc = subprocess.run(cmd, cwd=REPO, env=env, stdout=logf,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise SystemExit(f"{name} side failed (rc {rc}), see "
                         f"{out_dir / (name + '.log')}")
    res = json.loads((out_dir / f"{name}.json").read_text())
    res["_wall_s"] = round(time.time() - t0, 1)
    return res


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out_dir", required=True)
    p.add_argument("--width", type=int, default=240)
    p.add_argument("--height", type=int, default=136)
    p.add_argument("--n", type=int, default=30000)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--threads", type=int, default=6)
    args = p.parse_args()
    if args.height % 4 or args.width % 4:
        raise SystemExit("width and height must be multiples of 4")
    out_dir = Path(args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "RODYGS_PREALIGN_DEBUG": "1",
           "OMP_NUM_THREADS": str(args.threads), "PYTHONPATH": str(REPO)}
    script = str(REPO / "scripts" / "flagship_1080p.py")
    sides = {
        "jax": [sys.executable, "-c", _JAX_SIDE.format(script=script)]
               + flags(args, out_dir / "jax.json", out_dir / "jax_state"),
        "torch": [sys.executable, "-m", "rodygs_tpu_torch.tools.flagship_1080p",
                  "--device", "cpu"]
                 + flags(args, out_dir / "torch.json",
                         out_dir / "torch_state"),
    }
    rows = {}
    for name, cmd in sides.items():
        res = run_side(name, cmd, out_dir, env)
        pn = res["pose_noise"]
        rows[name] = {
            "ate_init": pn["init_scores"]["ATE"],
            "ate_prealign": pn["prealign_scores"]["ATE"],
            "rpe_rot_init": pn["init_scores"]["RPE_rot"],
            "rpe_rot_prealign": pn["prealign_scores"]["RPE_rot"],
            "retry": pn["prealign"]["retry"],
            "view_losses": pn["prealign"]["view_losses"],
            "wall_s": res["_wall_s"]}
        print(f"{name}: {json.dumps(rows[name])}", flush=True)
    print(json.dumps({"width": args.width, "height": args.height,
                      "n": args.n, "steps": args.steps, **rows}))


if __name__ == "__main__":
    main()
