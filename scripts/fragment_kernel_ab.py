#!/usr/bin/env python3
"""Time expand and segsum of several source trees on one NVIDIA GPU.

    python3 scripts/fragment_kernel_ab.py TREE [TREE ...]

Each TREE is a directory that holds `chip_smoke.py` and `rodygs_tpu_torch/`
(`.` for this tree, a second tree with one design step changed, a tree
named twice to see the spread). For each, in a process of its own, the
kernels are built from that tree's `csrc`, three seeded renders are
captured through that tree's port (`kernel_check.random_scene` /
`capture_stages`: 1920x1080 with 240,000 gaussians in rows mode; 512x512
with 131,072 gaussians at two scales, one filling the capacity and one
filling about half of it), expand and segsum are held against their plain
versions (`kernel_check.check_stages(tiles=False)`; a mismatch is printed,
not raised, so a deliberately cut-down kernel can still be timed) and timed
with that tree's `chip_smoke.graph_ms` (warm) and `chip_smoke.cold_ms`
(cold). One line per tree and render; the card's name and power limit
first. It is a cheaper companion of running every tree's `chip_smoke.py`:
no training, about 20 s a tree. Imports neither JAX nor the JAX package.
"""

import subprocess
import sys

RENDERS = (
    ("1080p-rows", 240_000, 1920, 1080, (-5.6, -4.2), "rows"),
    ("512-full", 131_072, 512, 512, (-4.0, -2.6), True),
    ("512-half", 131_072, 512, 512, (-4.9, -3.5), True),
)

CHILD = r'''
import sys
sys.path.insert(0, ".")
import chip_smoke as cs
from rodygs_tpu_torch import kernels, kernel_check as KC
from rodygs_tpu_torch.render import compact as C

tag, renders = sys.argv[1], eval(sys.argv[2])
kernels.build_all()
for name, n, w, h, log_scale, tight in renders:
    params, cam = KC.random_scene(n, 5, "cuda", log_scale=log_scale)
    s = KC.capture_stages(params, None, cam, 3, w, h, "lean", tight, 3)
    cb, d, tab = s["cb"], s["d_presort"], s["table"]
    try:
        KC.check_stages(s, tiles=False)
        ok = "matches plain"
    except KC.KernelMismatch as e:
        ok = f"MISMATCH ({e})"
    seg = lambda: C.segment_sum_rows(d, tab, cb.bases, cb.f_kept)
    exp = lambda: C.expand_fragments(tab, cb.bases, cb.f_kept, s["tx"],
                                     s["db"], d.shape[0])
    print(f"[ab] {tag} {name} f_kept={int(cb.f_kept)} of {d.shape[1]}: "
          f"expand warm {cs.graph_ms(exp):.4f} cold {cs.cold_ms(exp):.4f} ms, "
          f"segsum warm {cs.graph_ms(seg):.4f} cold {cs.cold_ms(seg):.4f} ms; "
          f"{ok}", flush=True)
'''


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    failed = 0
    for tree in trees:
        run = subprocess.run([sys.executable, "-c", CHILD, tree, repr(RENDERS)],
                             cwd=tree, capture_output=True, text=True)
        lines = [l for l in run.stdout.splitlines() if l.startswith("[ab]")]
        print("\n".join(lines), flush=True)
        if run.returncode != 0:
            failed += 1
            print(f"[ab] {tree} failed:\n{run.stdout[-2000:]}\n"
                  f"{run.stderr[-3000:]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
