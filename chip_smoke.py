#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. build   — compile the four CUDA kernels of rodygs_tpu_torch/csrc (and
               the empty kernel of launch_floor.cu) from source (one nvcc
               per file, in parallel); print the seconds, ptxas's registers
               and shared memory, and the blocks of every kernel's
               instantiations that one SM holds (the CUDA runtime's count).
  2. check   — on a 128x128, 5k-gaussian render's own binning (tight=True
               and tight="rows"), hold every kernel against its plain
               PyTorch version on the card, and a full CUDA render against
               the same render on the CPU. Then the inputs the tile
               kernels' parts fear: needles and blobs with opacities on
               both sides of 1/255 (the cull's margin), hand-made tiles of
               0, 32, 33, 64, 65 and 2,100 fragments (batch edges), the
               second half of the tile grid under tile_id_offset = T/2,
               both include_normal settings, and the backward twice on the
               same inputs for equal bits. segsum runs twice for equal bits
               wherever it is checked. A render and its gradients with
               every record that expand leaves unwritten set to NaN must
               give the bits of the unpoisoned render.
  3. train   — the bench.py workload through the port's public entry
               points: 512x512, 100k points in a 131,072-slot store, SH 3,
               8 frames, L1 0.8 + D-SSIM 0.2, camera lr 1e-5 / 1e-6, 200
               `train_iteration`s from iteration 1, so the capacity
               poller's initial fit (iteration 5) and its steady-state
               polls (125-200) run before the steps that are timed; the
               profile's changes and each frame's demand are printed.
               Launch counters are zeroed just before and read just
               after; asserts the loss falls, pose gradients are non-zero,
               every kernel launched and the capacity profile kept 1 band.
               Prints step_ms (median of the last 10 synchronised steps),
               the spread of the last 50, and Mpix/s.
  3a. bench — `rodygs_tpu_torch/tools/bench.py` (the counterpart of
               bench.py) in this process at both of its points: 512x512 /
               100k (capacity 131,072, 8 frames, 9 windows x 10) and
               1920x1080 / 240k (262,144, 4 frames, 5 windows x 8), each
               after 95 warm-up iterations numbered 910-1004; the tool's
               card line and JSON line printed here. Requires bench.py's
               keys, a finite value above 0, no error and a steady window
               at each point, and every kernel launched in each point's
               timed windows (the tool zeroes the counts just before its
               windows and reads them just after). Then the four kernels
               against their plain versions on frame 0 of each point's
               state as its windows left it, at the profile it settled
               at (expand and segsum on every sort band), nothing
               dropped.
  4. profile — torch.profiler over 5 more steps: device time by kernel,
               the device's busy share of the wall time, and the device
               time of the fragment-scale PyTorch operations around the
               four kernels (sort, record gather, stack_records, unsort
               scatter, tile_bwd's zero fill), found by their shapes.
  5. time    — each kernel, its plain version and (segsum) the one-call
               library equivalent `index_add_`, timed at the shapes of the
               trained state's render; the least time (bound) from the
               bytes and operations of this run's inputs; the tile-count
               distribution and the (warp, fragment) pair counts of that
               render (`kernel_check.walk_stats`) and its slot ranges
               (`kernel_check.slot_stats`). expand, segsum, `index_add_`
               and the empty kernel are read twice: warm (`graph_ms`: a
               CUDA graph of 20 launches replayed back to back, no host in
               between, inputs and outputs resident in the 50 MB L2) and
               cold (`cold_ms`: a 256 MB buffer overwritten before every
               launch, events around the one launch). The train step lies
               between the two: expand's table and segsum's rows were
               written just before by kernels that move more than the L2
               holds.
  5a. variants — on the trained state of phase 3 at 512x512: the legacy
               path (`render(binning_mode="legacy")`: broadcast-tier
               binning, records gather, the tile kernels) forward and
               backward with launch counters zeroed just before and read
               just after (tile_fwd and tile_bwd, neither expand nor
               segsum); against the compact path over the same circle
               rects: the same fragment counts, bit-identical outputs on
               every tile whose fragment order agrees, and every order
               difference a tie of the quantized depth key; the legacy
               records put in the compact order equal to the compact
               path's sorted records; the tile kernels on the legacy
               records (P a multiple of 128, 2,048 zero dummy columns, row
               13 the constant 1) against their plain versions; the legacy
               reduction (`index_add_`) within segsum's bar of segsum on
               the same fragment gradients; the legacy render and its
               gradients at 128x128 against the CPU. Then the bf16 payload
               (1e-2 image, 3e-2 gradients against float32) and the gather
               unsort and gather records (bit-identical to sort) on the
               trainer's render, all four kernels launched; both renders
               against the dense oracle (render/composite_ref.py) at
               256x256 with 2,000 gaussians (2e-5 image / alpha, 2e-4 depth
               / normal; the compact render off the tiles whose order a
               depth-key tie changes, where the difference is printed); 50 steps
               of a second bench trainer with `camera_sparse_adam`, each
               moving only its frame's pose row, moments and count; and the
               render's forward + backward times, legacy and compact.
  5b. 1080p  — one captured 1920x1080 render of 240,000 seeded gaussians in
               rows mode (8,160 tiles, 40-row table): expand and segsum
               against their plain versions, slot ranges, warm and cold
               times and bounds. The tile kernels' plain versions run at
               this size in phase 7, on the banded binnings.
  6. joint   — the joint RoDyGS iteration of the kubric config
               (`KUBRIC_*`, configs/train/train_kubric_mrig.yaml:103-239) at
               512x512: the bench static set (100k in 131,072 slots) and
               24,000 dynamic gaussians in 32,768 slots, 8 frames at times
               i/7; iterations 481-640, each a static step and a dynamic
               step (rigidity every 5th), both models densifying at 600.
               Launch counters are zeroed just before. Prints the static,
               dynamic and joint ms (medians of the last 10, synchronised),
               each DensifyInfo with the alive counts around it, and the
               settled fragment profiles; requires finite losses, a falling
               dynamic loss, a moving motion model, clone + split > 0 in the
               static store, alive counts that fit the DensifyInfo, no
               overflow at the end and every kernel launched. Then the four
               kernels against their plain versions on frame 0's
               concatenated static + deformed dynamic set, and
               torch.profiler over 5 joint iterations (one with rigidity)
               and over one densification call of each model.
  7. eval    — the evaluator on the joint phase's end state: both
               checkpoints through `RoDyGSTrainer.save_checkpoints`, a test
               set of 4 views halfway between the train cameras (GT: the
               joint GT render + noise), `RoDyGSEvaluator.eval` without
               alignment (configs/eval/eval_wo_align.yaml) in chunks of 2;
               then with alignment (eval_w_align.yaml: camera lr 5e-5, 1000
               steps) on 2 views, each view's optimisation synchronised and
               timed. Launch counters are zeroed just before each eval()
               call and read just after it. Outside the calls: the views
               rendered again at the settled profile, the photometric L2 at
               each aligned view's start and end pose, the median of 50
               synchronised pose steps, torch.profiler over 20 pose steps,
               the four kernels against their plain versions on a pose
               step's render; LPIPS (both nets, seeded random weights) on
               one 512x512 pair on the card against the CPU; the 1080p state
               of phase 5b rendered with its gradients at profile "huge"
               with 1, 2 and 4 sort bands (counters zeroed just before and
               read just after: expand and segsum launch once a band), then
               the four kernels against their plain versions on its 2- and
               4-band binnings (expand and segsum on every band, the tile
               kernels on the bands' concatenated records). Requires finite
               metrics, no dropped fragments at the settled profile, PNGs
               that decode to the images, the L2 falling on every aligned
               view, LPIPS within 1e-4 relative, banded images bit-identical
               to one band's and every kernel launched inside eval().
  8. cli     — the port's entry points on a scene on disk. The host ops
               must be native. The time embedding at the shipped 26
               frequencies for the 24 frame times, on the card and the
               CPU, against float64 (columns past 1e-6). data/synthetic.py
               writes a kubric-shaped scene (512x512, 24 train frames at
               times i/23, 4 test views halfway after train frames 2, 8,
               14, 20, plys of 5,000 static and 1,000 dynamic points a
               frame, MASt3R poses perturbed by 0.3 deg / 0.01) under
               mast3r_opt/exp0 and swin_noloop_000. Then, each a
               subprocess: `python -m rodygs_tpu_torch.pipelines.train -b
               configs/train/train_kubric_mrig.yaml --num_iterations 700
               --checkpoint_every 350` at the config's widths (both models
               densify at 600), and `...pipelines.eval` with
               eval_wo_align.yaml and with eval_w_align.yaml cut to 100
               pose steps by a dotlist override. Requires exit code 0, a
               falling static loss, both *_last.ckpt files, resume.ckpt
               read back by the port's load_resume as iteration 701 with
               the end state, finite PSNR / SSIM / MS-SSIM / ATE / RPE, a
               video.mp4 and the PNGs, no pose step that dropped fragments
               and every kernel launched (the CLIs log their launch
               counts). The four kernels against their plain versions on
               the concatenated render of frame 0 of the restored end
               state. Prints the data-load seconds, the StepTimer's p50,
               each CLI's wall seconds and launches.
  9. multi   — multi-device training on the one card (no multi-GPU
               speed is measured). (a) The trained 512x512 state of phase 3:
               its compact render (expand, sort, tile forward; tile
               backward, unsort, segsum) split into 2, 3 and 8 tile blocks
               at their global tile offsets, the planes concatenated
               bit-identical to the whole grid's, the blocks' table
               gradients summed within 1e-5 of the whole grid's maximum.
               (b) The sharded static step over one NCCL rank (world size
               1) against the trainer's step: params, poses and moments
               bit-identical. (c) A world of 4 processes on the card over
               Gloo (parallel/dryrun.run_world): meshes 2x1x2 and 1x2x2 of
               the sharded static step at the bench workload (512x512,
               100,000 gaussians in 131,072 slots; the 1x2x2 store
               interleaved over 2 gauss blocks), the first step's
               gradients within 5e-4 of their max and its loss within
               1e-5 relative of one process's mean-frame gradients and
               loss on the same global store, 20 steps each with a falling
               loss equal on every rank, one sharded densification, the
               Gloo all-reduce of the parameter gradients over the data
               axis timed; then on 1x2x2 the sharded joint iteration at the
               kubric size (100k static, 24k dynamic) for iterations
               598-600 (both stores densify at 600), finite and moving;
               each rank counts its kernel launches, and rank 0 holds the
               four kernels against their plain versions on its share of
               the render (the tile kernels on its block at its offset,
               every fragment outside it at zero gradient). (d) The train
               CLI under `torch.distributed.run --standalone
               --nproc_per_node 2` with RODYGS_DIST_BACKEND=gloo and
               `--mesh data=2` on phase 8's scene: 100 iterations with a
               snapshot every 50, then `--resume` to 150; train.log and
               train.p1.log, one writer's files, and the single-process
               port loads resume.ckpt.
 10. flagship — `rodygs_tpu_torch/tools/flagship_1080p.py`'s functions
               at the tool's full size: 1920x1080, 120,000 static + 120,000
               dynamic gaussians in stores of 262,144 slots, 12 frames,
               motion masks, pose noise 0.5 deg / 0.025 with the
               pre-alignment ladder cut to 25 steps a level, 300 joint
               iterations (both models densify at 100, 200 and 300), the
               held-out view's `eval_w_align` cut to 200 steps
               (FLAGSHIP_ARGS). Launch counters are zeroed just before the
               tool's `train` and read just after it, and must equal two
               tile_fwd / tile_bwd launches an iteration and one expand /
               segsum launch a sort band of each render. Requires finite
               window losses, a static one that falls from the first
               window to the last, no drop at the end nor in either PSNR
               render, the held-out view's L2 falling over the alignment;
               prints every escalation, the ATE before and after, the
               PSNRs and what they drop at the trainer's profile, the peak
               memory and the tool's result JSON line. Then the four
               kernels against their plain versions on frame 0's
               concatenated 1080p render of the end state, each kernel's
               device time and bound on that render, torch.profiler
               over iterations 304-306 (305 a rigidity iteration: the
               `motion_mlp` / `rigidity_knn` ranges, each kernel's device
               time a launch) and one densification call of each model.
 11. scaling — the multi-device and sort tools (rodygs_tpu_torch/tools/).
               (a) A 1-rank NCCL world in this process: at 512x512 / 100,000
               (the JAX scaling script's default) and at 1920x1080 /
               240,000 (the flagship's width), each at the fragment profile
               its frames 0-3 need ("lean" unless their demand asks more),
               the tool's first sharded step against the trainer's own step
               on the same state (params, poses, moments, statistics and
               loss bit-identical), then `scaling_bench.run` (the 1-rank
               baseline, 10 timed steps; launch counters zeroed by the tool
               just before its warm-up step and read after its last step:
               11 of each kernel). (b) `scaling_bench` in a 2-rank Gloo
               world sharing the card at 512x512 over 2x1x1, 1x2x1, 1x1x2
               and the baseline (correctness only: every row, the tile and
               gauss meshes' first loss equal to the baseline's within
               1e-5, every rank launching every kernel). (c)
               `measure_dyn_replication` at 262,144 slots against phase
               10's ms an iteration. (d) `sort_microbench`'s curve and its
               [4, C/4] banded point. (e) With 4 cards or more: the sweep
               under `torch.distributed.run --standalone --nproc_per_node
               4` over NCCL at both workloads (every factorisation of 4),
               `multihost_smoke --ranks 4 --backend nccl`, and on rank 0
               of a 2x1x2 step the four kernels against their plain
               versions on its share of its render. (f) With 4 cards: the
               train CLI under `torch.distributed.run --standalone
               --nproc_per_node 4` over NCCL, one card per rank, `--mesh
               data=4`, train_kubric_mrig.yaml on phase 8's scene: 700
               iterations with a snapshot every 350 (both models densify
               at 600), then `--resume` to 750; exit code 0 twice, one
               run directory with one writer's files, a log per rank with
               its mesh row and the resume line, the same logged losses
               and store sizes after the densification on every rank,
               every kernel launched on every rank, resume.ckpt loaded by
               the single-process port with the static store of
               static_last.ckpt, the eval_wo_align CLI on the run's
               checkpoints with finite PSNR / SSIM / LPIPS (seeded LPIPS
               weights), and the four kernels against their plain
               versions on the end state's concatenated render; prints
               each rank's StepTimer p50 and the efficiency p50(phase 8)
               / p50(four cards). With fewer cards one line each says
               that (e) and (f) were not run and why.
 12. report  — the card's name and power limit (nvidia-smi), one JSON line
               of per-kernel numbers (`launches_bench`: in each point's
               timed windows of phase 3a; `launches_joint`: launches in
               phase 6;
               `launches_eval`: inside the two eval() calls of phase 7;
               `launches_bands`: in its three banded renders;
               `launches_cli`: in each CLI of phase 8; `launches_multi`:
               each rank's launches in phase 9c; `launches_torchrun`: each
               rank's in phase 9d's first run; `launches_flagship`: in
               phase 10's training; `launches_scaling`: in each workload's
               1-rank baseline of phase 11a; `launches_four_card`: each
               rank's over both four-card sweeps of phase 11e, null when
               it did not run; `launches_four_card_cli`: each rank's in
               phase 11f's first run, null when it did not run;
               `flagship`: ms and bound_ms on phase 10's
               frame-0 render, train_ms_per_launch in its profile),
               and last
               {"ok": true, "device": ...}. The tile kernels' rows carry
               `launches_legacy` (one legacy render of phase 5a),
               `launches_variants` (its four variant renders) and
               `legacy_ms`, their times on the legacy records.

Without CUDA, or run from a directory without the package, it exits with
a non-zero code before printing any result. Imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP32
# (non-tensor-core) rate; the kernels do FP32 arithmetic outside the tensor
# cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# FP32 operations per evaluated (pixel, fragment) pair, an FMA counting as
# two and a transcendental as one. Every evaluated pair: offsets 2, conic
# form 9, negate and exp 2, opacity product 1, clamp 1, two tests 2 => 17;
# that is all a rejected pair costs (sigma < 0, alpha < 1/255, or the one
# that stops the pixel). A contributing pair adds, forward: log1p, add,
# stop test, the transmittance (an exp or a product step), weight 5 and the
# 8-channel accumulate 16 => 38; backward: the same 5, f.g 16, prefix 2,
# suffix 1, d_alpha 4, clamp select 1, d_sigma 2, the six geometry grads 19,
# 8 feature grads 8 and the 14-value pixel reduction 14 => 89.
# Without the normal rows (the trainer's renders) five channels are live and
# the alpha feature is the constant 1: the accumulate is 4 FMAs and an add,
# 9 => 31; backward f.g is 9, the feature grads 5 and the reduction 11 => 76.
# The rejected pairs are counted as the cheapest known correct walk needs
# them (`rejected_ops`): every pair a pixel rejects at 17, or one rectangle
# test per (warp, fragment) of the tile's walk and 17 for the rejected pairs
# inside the (warp, fragment) pairs the test keeps. The test
# (csrc/tile_common.cuh::rect_may_take): opacity and convexity 8, offsets
# and the inside test 8, two quotients 4, four clamped edge minima of the
# form 51, the margin's magnitude 16, log and compare 6 => 93.
# The work the function needs, whatever implements it.
REJECTED_OPS_PER_PAIR = 17
CULL_OPS_PER_TEST = 93
FWD_OPS_PER_CONTRIB = {True: 38, False: 31}
BWD_OPS_PER_CONTRIB = {True: 89, False: 76}

# threads of a block of the fragment kernels (one block per 512-slot chunk)
FRAGMENT_BLOCK_THREADS = {"expand": 512, "segsum": 256}

SOURCES = {
    "expand": ("rodygs_tpu_torch/csrc/expand.cu",
               "rodygs_tpu/render/compact.py:769"),
    "tile_fwd": ("rodygs_tpu_torch/csrc/tile_fwd.cu",
                 "rodygs_tpu/render/tile_kernel.py:360"),
    "tile_bwd": ("rodygs_tpu_torch/csrc/tile_bwd.cu",
                 "rodygs_tpu/render/tile_kernel.py:401"),
    "segsum": ("rodygs_tpu_torch/csrc/segsum.cu",
               "rodygs_tpu/render/compact.py:850"),
}


def card_name_and_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, group=20, replays=11):
    """Device time of one call of `fn`, warm: `group` calls captured into a
    CUDA graph, the graph replayed back to back with events around each
    replay; the median replay over `group`. No host work lies between the
    launches, so a kernel of a few microseconds is not timed by the speed
    of its Python wrapper; what it reads and writes stays in the L2."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(group):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(replays)]
    for start, end in pairs:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs])) / group


_FLUSH = {}


def cold_ms(fn, reps=51):
    """Device time of one call of `fn`, cold: before every call a 256 MB
    buffer (five times the L2) is overwritten four times, which also keeps
    the device busy (~0.35 ms) while the host enqueues the call, then events
    around the one call; the median of `reps`. Two events around nothing
    read `cold_ms(lambda: None)`; the empty kernel's reading is the floor."""
    import torch

    if "buf" not in _FLUSH:
        _FLUSH["buf"] = torch.empty(64 * 2**20, dtype=torch.float32,
                                    device="cuda")
    buf = _FLUSH["buf"]
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for n, (start, end) in enumerate(pairs):
        for _ in range(4):
            buf.fill_(float(n))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rejected_ops(contrib, rejected, warp_pairs):
    """Operations the rejected (pixel, fragment) pairs need at the least:
    the smaller of the per-pixel walk (every rejected pair evaluated) and,
    for each warp shape, a culled walk (one rectangle test per (warp,
    fragment) of the tile's walk, then only the lanes of kept pairs)."""
    counts = {"per pixel": REJECTED_OPS_PER_PAIR * rejected}
    for shape, n in warp_pairs.items():
        counts[f"culled {shape}"] = (
            CULL_OPS_PER_TEST * n["block_walk"]
            + REJECTED_OPS_PER_PAIR * (n["kept_lanes"] - contrib))
    walk = min(counts, key=counts.get)
    log("[time] operations for the rejected pairs: " + " ".join(
        f"{k}={v}" for k, v in counts.items()) + f"; the bound takes {walk!r}")
    return counts[walk]


def fragment_bounds(s, st):
    """expand's and segsum's bounds on one captured render (`st`: its
    `kernel_check.slot_stats`): ({"expand": (ms, by), "segsum": (ms, by)},
    the table words expand must read, expand's bound by the older count
    (every slot's 13 rows and the whole table)). expand: the key of every
    slot, the emitted record rows of the filled slots, and of the columns
    that own a filled slot the record rows, the four aux rows and, in rows
    mode, the mode flag and for a row-mode column its 16 span words.
    segsum: the summed rows of the filled slots, the offsets row, the
    output."""
    import torch
    from rodygs_tpu_torch.render import compact as C

    tab, bases = s["table"], s["cb"].bases
    n_rows, nw = s["d_presort"].shape[0], tab.shape[1]
    cap, n_kept = st["capacity"], st["f_kept"]
    rows_mode = tab.shape[0] >= C.NUM_TABLE_ROWS_RMODE
    owning = torch.diff(torch.clamp(tab[C.ROW_OFF], max=float(n_kept)),
                        append=tab.new_tensor([float(n_kept)])) > 0
    col_words = (n_rows + 4) * st["owning_columns"]
    if rows_mode:
        col_words += st["owning_columns"] + 2 * C.ROW_SPAN_MAX * int(
            (owning & (tab[C.ROW_RMODE] > 0.5)).sum())
    b_all, _ = bound(tab.numel() * 4 + bases.numel() * 4 + cap * 4 * 14, 0)
    return ({"expand": bound(4 * (cap + n_rows * n_kept + col_words
                                  + st["filled_chunks"] + 1), 0),
             "segsum": bound(n_rows * n_kept * 4 + nw * 4 + n_rows * nw * 4,
                             n_rows * n_kept)},
            col_words, b_all)


def kernel_calls(s):
    """{kernel: a call of it on one captured render}, the calls the time
    phase and the flagship phase time."""
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render import tile_kernel as TK

    cb = s["cb"]
    tab, bases, fk, d = s["table"], cb.bases, cb.f_kept, s["d_presort"]
    args = (s["records"], cb.tile_starts, cb.tile_counts, s["off"])
    normals = s["include_normal"]
    return {
        "expand": lambda: C.expand_fragments(tab, bases, fk, s["tx"],
                                             s["db"], d.shape[0]),
        "segsum": lambda: C.segment_sum_rows(d, tab, bases, fk),
        "tile_fwd": lambda: TK.rasterize_fwd_impl(*args, s["tx"], normals),
        "tile_bwd": lambda: TK.rasterize_bwd_impl(*args, s["out"], s["gout"],
                                                  s["tx"], normals)}


# the warm timer of each kernel's `ms`: the fragment kernels take a few
# microseconds, so host work must not lie between their launches
WARM_TIMER = {"expand": graph_ms, "segsum": graph_ms, "tile_fwd": time_ms,
              "tile_bwd": time_ms}


def time_fragment_kernels(s, tag):
    """expand and segsum on one captured render: {kernel: dict(ms (warm),
    cold_ms, plain_ms, library_ms, library_cold_ms, bound_ms, bound_by)}.
    The bounds count what this render's data needs. expand: the key of
    every slot, the emitted record rows of the filled slots, and of the
    columns that own a filled slot the record rows, the four aux rows and,
    in rows mode, the mode flag and for a row-mode column its 16 span
    words. segsum: the summed rows of the filled slots, the offsets row,
    the output."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render import compact as C

    cb = s["cb"]
    tab, bases, fk = s["table"], cb.bases, cb.f_kept
    d = s["d_presort"]
    n_rows, nw = d.shape[0], tab.shape[1]
    st = KC.slot_stats(s)
    cap, n_kept = st["capacity"], st["f_kept"]
    log(f"[{tag}] slots: C={cap} f_kept={n_kept} "
        f"({100 * n_kept / cap:.1f}% filled), chunks filled "
        f"{st['filled_chunks']} of {st['chunks']}, columns owning a filled "
        f"slot {st['owning_columns']} of {st['table_columns']}; slots per "
        f"owning gaussian " + " ".join(
            f"{k}={v:.1f}" for k, v in st["slots_per_gaussian"].items())
        + f"; share of filled slots in ranges > 32: "
        f"{100 * st['share_over_32']:.2f}%, > 512: "
        f"{100 * st['share_over_512']:.2f}%; ranges crossing a chunk edge "
        f"{st['cross_chunk']}")
    bounds, col_words, b_all = fragment_bounds(s, st)
    calls = kernel_calls(s)
    res = {}

    def both(fn):
        return graph_ms(fn), cold_ms(fn)

    b, by = bounds["expand"]
    warm, cold = both(calls["expand"])
    res["expand"] = dict(
        ms=warm, cold_ms=cold,
        plain_ms=time_ms(lambda: C.expand_fragments_plain(
            tab, bases, fk, s["tx"], s["db"], n_rows), reps=3),
        library_ms=None, library_cold_ms=None, bound_ms=b, bound_by=by)
    log(f"[{tag}] expand bound: {b:.4f} ms for what this render needs "
        f"({n_rows} rows of {n_kept} slots, {col_words} table words); every "
        f"slot's 13 rows and the whole table, as counted before: "
        f"{b_all:.4f} ms")

    # segsum reads only the f_kept filled slots; so does the library call
    d_kept = d[:, :n_kept]
    owner = torch.searchsorted(
        tab[C.ROW_OFF], torch.arange(n_kept, device=d.device,
                                     dtype=torch.float32), right=True) - 1
    b, by = bounds["segsum"]
    warm, cold = both(calls["segsum"])
    lib = lambda: torch.zeros((n_rows, nw), device=d.device).index_add_(
        1, owner, d_kept)
    lib_warm, lib_cold = both(lib)
    res["segsum"] = dict(
        ms=warm, cold_ms=cold,
        plain_ms=time_ms(lambda: C.segment_sum_rows_plain(d, tab, fk), reps=5),
        library_ms=lib_warm, library_cold_ms=lib_cold, bound_ms=b, bound_by=by)
    for name, t in res.items():
        log(f"[{tag}] {name}: warm {t['ms']:.4f} ms, cold {t['cold_ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library warm "
            f"{t['library_ms']} cold {t['library_cold_ms']}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return res


def launch_floors():
    """The empty kernel through both timers, at the grids of the two
    fragment kernels, and the cold timer around nothing."""
    from rodygs_tpu_torch import kernels

    for blocks, threads in ((1, 32), (1536, 512)):
        fn = lambda: kernels.launch("launch_floor", blocks, threads)
        log(f"[time] empty kernel <<<{blocks}, {threads}>>>: warm "
            f"{graph_ms(fn):.4f} ms, cold {cold_ms(fn):.4f} ms")
    log(f"[time] the cold timer's two events around no launch: "
        f"{cold_ms(lambda: None):.4f} ms")


def tile_bounds(s):
    """The tile kernels' bounds on one captured render: ({"tile_fwd": (ms,
    by), "tile_bwd": (ms, by)}, contributing pairs, rejected pairs,
    `kernel_check.walk_stats`). The compositors read the used rows of the
    fragments in tile ranges (6 geometry rows and the live feature rows;
    the alpha feature is a constant without normals); the forward writes
    all 8 planes; the backward reads the live planes of O and g and writes
    all 16 rows of d_records."""
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render import tile_kernel as TK

    cb = s["cb"]
    normals = s["include_normal"]
    num_tiles = cb.tile_starts.shape[0]
    plane_bytes = num_tiles * TK.PIX * 4
    n_live = 8 if normals else 5
    rec_bytes = ((14 if normals else 10) * int(cb.tile_counts.sum()) * 4
                 + num_tiles * 8)
    contrib, rejected = KC.needed_pairs(s)
    stats = KC.walk_stats(s)
    ops_rejected = rejected_ops(contrib, rejected, stats["warp_pairs"])
    return ({"tile_fwd": bound(rec_bytes + 8 * plane_bytes,
                               FWD_OPS_PER_CONTRIB[normals] * contrib
                               + ops_rejected),
             "tile_bwd": bound(rec_bytes + 2 * n_live * plane_bytes
                               + 16 * s["records"].shape[1] * 4,
                               BWD_OPS_PER_CONTRIB[normals] * contrib
                               + ops_rejected)},
            contrib, rejected, stats)


def time_kernels(s):
    """{kernel: dict(ms, plain_ms, library_ms, bound_ms, bound_by)}; the
    fragment kernels also cold_ms and library_cold_ms."""
    import torch
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render import tile_kernel as TK

    cb = s["cb"]
    cap = cb.bases.shape[0] * C.FCHUNK
    n_kept = int(cb.f_kept)
    args = (s["records"], cb.tile_starts, cb.tile_counts, s["off"])
    normals = s["include_normal"]
    p_cols = s["records"].shape[1]
    num_tiles = cb.tile_starts.shape[0]
    bounds, contrib, rejected, stats = tile_bounds(s)
    calls = kernel_calls(s)
    launch_floors()
    res = time_fragment_kernels(s, "time")

    b, by = bounds["tile_fwd"]
    res["tile_fwd"] = dict(
        ms=time_ms(calls["tile_fwd"]),
        plain_ms=time_ms(lambda: TK.rasterize_fwd_plain(*args, s["tx"],
                                                        normals), reps=2),
        library_ms=None, bound_ms=b, bound_by=by)
    b, by = bounds["tile_bwd"]
    res["tile_bwd"] = dict(
        ms=time_ms(calls["tile_bwd"]),
        plain_ms=time_ms(lambda: TK.rasterize_bwd_plain(
            *args, s["out"], s["gout"], s["tx"], normals), reps=2),
        library_ms=None, bound_ms=b, bound_by=by)
    # the heaviest tile alone: what one block's serial walk takes, the floor
    # of any one-block-per-tile design on this data
    heavy = int(cb.tile_counts.argmax())
    h_args = (s["records"], cb.tile_starts[heavy:heavy + 1].contiguous(),
              cb.tile_counts[heavy:heavy + 1].contiguous(),
              torch.tensor([heavy], dtype=torch.int32,
                           device=s["records"].device))
    h_out = s["out"][heavy:heavy + 1].contiguous()
    h_gout = s["gout"][heavy:heavy + 1].contiguous()
    log(f"[time] heaviest tile alone ({int(cb.tile_counts[heavy])} "
        f"fragments, one block): tile_fwd "
        f"{time_ms(lambda: TK.rasterize_fwd_impl(*h_args, s['tx'], normals)):.4f}"
        f" ms, tile_bwd "
        f"{time_ms(lambda: TK.rasterize_bwd_impl(*h_args, h_out, h_gout, s['tx'], normals)):.4f}"
        f" ms (with its zero fill)")
    log(f"[time] zero fill of d_records [16, {p_cols}] inside tile_bwd's "
        f"wrapper: {time_ms(lambda: torch.zeros_like(s['records'])):.4f} ms")
    log(f"[time] C={cap} P={p_cols} tiles={num_tiles} f_kept={n_kept} "
        f"include_normal={normals} pairs: contributing={contrib} "
        f"rejected={rejected}")
    for k in ("tile_counts", "tile_walked"):
        log(f"[time] {k} (fragments per tile): " + " ".join(
            f"{n}={v:.1f}" for n, v in stats[k].items()))
    for shape, n in stats["warp_pairs"].items():
        log(f"[time] (warp, fragment) pairs, warp = {shape} "
            f"{TK.WARP_SHAPES[shape]}: " + " ".join(
                f"{k}={v}" for k, v in n.items()))
    return res


def occupancy_lines(build_log):
    """ptxas's register, spill and shared-memory lines of every kernel, and
    the blocks of each kernel's instantiations one SM holds: the runtime's
    count from registers, static and dynamic shared memory and threads."""
    from rodygs_tpu_torch import kernels

    lines = []
    for name, text in build_log.items():
        entry = name
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:   # the template argument, ILb0E / ILb1E, tells the two apart
                entry = f"{name}<{m.group(1)}>"
            if "registers" in line or "spill" in line:
                lines.append(f"[build] {entry}: {line.strip()}")
    for name in ("tile_fwd", "tile_bwd"):
        for normals in (False, True):
            blocks = kernels.blocks_per_sm(name, normals)
            require(blocks > 0, f"{name} does not fit an SM")
            lines.append(f"[build] {name} include_normal={normals}: {blocks} "
                         f"resident blocks of 256 threads per SM")
    variants = [("expand", 2 * rows + wide, f"rows_mode={bool(rows)} "
                 f"n_rows={13 if wide else 10}")
                for rows in (0, 1) for wide in (0, 1)]
    variants += [("segsum", wide, f"n_rows={13 if wide else 10}")
                 for wide in (0, 1)]
    for name, variant, text in variants:
        blocks = kernels.blocks_per_sm(name, variant)
        require(blocks > 0, f"{name} does not fit an SM")
        lines.append(f"[build] {name} {text}: {blocks} resident blocks of "
                     f"{FRAGMENT_BLOCK_THREADS[name]} threads per SM")
    return lines


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_check(device):
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.rasterize import render

    from rodygs_tpu_torch.render import tile_kernel as TK

    errs = {}

    def keep(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    params, cam = KC.random_scene(5000, 3, device, log_scale=(-4.0, -2.6))
    for tight in (True, "rows"):
        s = KC.capture_stages(params, None, cam, 3, 128, 128, "lean", tight, 1)
        e = KC.check_stages(s)
        log(f"[check] 128x128 n=5000 tight={tight!r} "
            f"fragments={int(s['cb'].num_fragments)} max_abs_err={e}")
        keep(e)

    # the second half of the tile grid alone, under tile_id_offset = T/2
    cb, half = s["cb"], s["cb"].tile_starts.shape[0] // 2
    off = torch.tensor([half], dtype=torch.int32, device=device)
    args = (s["records"], cb.tile_starts[half:].contiguous(),
            cb.tile_counts[half:].contiguous(), off)
    e = KC.check_tiles(*args, s["tx"], False)
    out = TK.rasterize_fwd_impl(*args, s["tx"], False)
    require(torch.equal(out, s["out"][half:]),
            "tile_fwd under tile_id_offset differs from the whole render")
    log(f"[check] tile_id_offset={half}: max_abs_err={e}, forward equal to "
        f"the whole render's second half")
    keep(e)

    # needles and blobs, opacities on both sides of 1/255: the cull's margin
    nb_params, nb_cam = KC.random_scene(5000, 3, device, log_scale=(-6.0, -1.0),
                                        opacity=(0.004, 0.99))
    for include_normal in (False, True):
        s = KC.capture_stages(nb_params, None, nb_cam, 3, 128, 128, "lean",
                              True, 1, include_normal=include_normal)
        e = KC.check_stages(s)
        log(f"[check] needles and blobs include_normal={include_normal} "
            f"fragments={int(s['cb'].num_fragments)} max_abs_err={e}")
        keep(e)

    # batch edges: tiles of 0, one batch, one more, and over 2,000 fragments
    counts = [0, 32, 33, 64, 65, 1, 2100, 0, 31, 129, 2500, 64]
    rec, starts, cnts, off = KC.synthetic_tiles(counts, 4, device, 4)
    for include_normal in (False, True):
        if include_normal:
            gen = torch.Generator(device=device).manual_seed(2)
            rec[10:14] = torch.rand((4, rec.shape[1]), generator=gen,
                                    device=device)
        e = KC.check_tiles(rec, starts, cnts, off, 4, include_normal)
        log(f"[check] tile counts {counts} include_normal={include_normal}: "
            f"max_abs_err={e}; tile backward twice: equal bits")
        keep(e)

    # the whole render on the card against the same render on the CPU
    with torch.no_grad():
        args = lambda p: (p.xyz, G.get_features(p), G.get_opacity(p),
                          G.get_scaling(p), p.rotation)
        gpu = render(*args(params), cam, 3, 128, 128)
        cpu_params = type(params)(*[x.cpu() for x in params])
        cpu_cam = type(cam)(*[x.cpu() for x in cam])
        ref = render(*args(cpu_params), cpu_cam, 3, 128, 128)
    for k in ("rendered_image", "rendered_alpha", "rendered_depth"):
        e = float((gpu[k].cpu() - ref[k]).abs().max())
        tol = 2e-4 if k == "rendered_depth" else 1e-4
        log(f"[check] render cuda vs cpu {k}: max_abs_err={e:.3g} (tol {tol})")
        require(math.isfinite(e) and e <= tol, f"render {k} differs: {e}")

    # nothing reads the records expand leaves unwritten: NaN there gives
    # the same render and the same gradients, bit for bit
    def render_and_grads():
        leaves = [x.detach().clone().requires_grad_(True) for x in params]
        p = type(params)(*leaves)
        out = render(*args(p), cam, 3, 128, 128)
        (out["rendered_image"].square().mean()
         + out["rendered_depth"].mean()).backward()
        return [out["rendered_image"].detach(),
                out["rendered_depth"].detach()] + [x.grad for x in leaves]

    clean = render_and_grads()
    with KC.poisoned_expand():
        poisoned = render_and_grads()
    require(all(torch.isfinite(x).all() for x in clean),
            "render or gradients not finite")
    require(all(torch.equal(a, b) for a, b in zip(clean, poisoned)),
            "NaN in the records expand leaves unwritten changed the render "
            "or its gradients")
    log("[check] records of empty slots poisoned with NaN: render and "
        f"{len(clean) - 2} gradients keep their bits")
    return errs


def phase_1080p(device, n=240_000, width=1920, height=1080):
    """expand and segsum on a 1920x1080 rows-mode render of n seeded
    gaussians: checked against their plain versions and timed. Returns
    ({kernel: max_abs_err}, {kernel: timings})."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC

    params, cam = KC.random_scene(n, 5, device, log_scale=(-5.6, -4.2))
    s = KC.capture_stages(params, None, cam, 3, width, height, "lean", "rows",
                          3)
    cb = s["cb"]
    log(f"[1080p] {width}x{height} n={n} tight='rows' tiles="
        f"{cb.tile_starts.shape[0]} table rows={s['table'].shape[0]} "
        f"fragments={int(cb.num_fragments)} dropped={int(cb.dropped)}")
    require(s["table"].shape[0] == 40, "not the rows-mode table")
    errs = KC.check_stages(s, tiles=False)
    log(f"[1080p] max_abs_err={errs}; segsum twice: equal bits")
    timings = time_fragment_kernels(s, "1080p")
    del s
    torch.cuda.empty_cache()
    return errs, timings


def bench_trainer(device, size=512, N=100_000, capacity=131072,
                  camera_sparse_adam=False, mesh=None):
    """bench.py's 512^2 / 100k workload, built through the port's
    `tools.bench.build_workload` (with `camera_sparse_adam` or on `mesh`:
    the trainer rebuilt on the same scene; on a mesh, this rank's trainer
    of the sharded step)."""
    import dataclasses
    from rodygs_tpu_torch.tools.bench import build_workload
    from rodygs_tpu_torch.train.trainer_static import ThreeDGSTrainer

    work = build_workload(size, size, N, capacity, 8, device=device)
    trainer = work.trainer
    if camera_sparse_adam or mesh is not None:
        cfg = dataclasses.replace(trainer.cfg,
                                  camera_sparse_adam=camera_sparse_adam)
        trainer = ThreeDGSTrainer(cfg, trainer.loss, trainer.state.store,
                                  trainer.state.poses,
                                  spatial_lr_scale=trainer.spatial_lr_scale,
                                  device=device, mesh=mesh)
    return trainer, work.batch_for, (size, size)


def phase_train(device, iterations=200, **scene):
    import torch
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.render.compact import split_profile

    t0 = time.perf_counter()
    trainer, batch_for, (W, H) = bench_trainer(device, **scene)
    torch.cuda.synchronize()
    log(f"[train] set-up {time.perf_counter() - t0:.2f} s")
    poses0 = [x.clone() for x in trainer.state.poses]

    losses, step_s, frags, profiles = [], [], [], []
    kernels.reset_launches()
    for it in range(1, iterations + 1):
        t = time.perf_counter()
        m = trainer.train_iteration(batch_for(it - 1), it)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        frags.append(int(m["num_fragments"]))
        if not profiles or profiles[-1][1] != trainer.fragment_profile:
            profiles.append((it, trainer.fragment_profile))
    launches = dict(kernels.LAUNCHES)
    log(f"[train] launches on the main path: {launches}")
    log(f"[train] capacity profile from iteration: {profiles}; fragment "
        f"demand of the 8 frames, first pass {frags[:8]}, last pass "
        f"{frags[-8:]}")

    require(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    first, last = np.mean(losses[:8]), np.mean(losses[-8:])
    log(f"[train] loss first-8 mean {first:.6f} -> last-8 mean {last:.6f}")
    require(last < first, "loss did not fall")
    moved = [float((a - b).abs().max())
             for a, b in zip(trainer.state.poses, poses0)]
    log(f"[train] pose change max |dq| {moved[0]:.3g} |dt| {moved[1]:.3g}")
    _, _, (_, g_poses, _) = trainer.loss_and_grads(
        trainer.state, batch_for(0), trainer.loss.active_set(iterations),
        trainer.active_sh_degree, trainer.fragment_profile)
    gq, gt = (float(g.abs().max()) for g in g_poses)
    log(f"[train] pose grad max |g_q| {gq:.3g} |g_t| {gt:.3g}")
    require(gq > 0 and gt > 0 and min(moved) > 0, "pose gradients are zero")
    require(all(launches[k] > 0 for k in kernels.KERNELS),
            f"a kernel never launched on the main path: {launches}")
    require(split_profile(trainer.fragment_profile)[1] == 1,
            f"profile left 1 band: {trainer.fragment_profile}")
    step_ms = float(np.median(step_s[-10:]) * 1e3)
    last50 = np.asarray(step_s[-50:]) * 1e3
    log(f"[train] {iterations} iterations; step_ms={step_ms:.3f} "
        f"(median of the last 10, synchronised) "
        f"mpix_per_s={W * H / 1e6 / (step_ms / 1e3):.3f} "
        f"last-50 median {np.median(last50):.3f} min {last50.min():.3f} "
        f"p90 {np.percentile(last50, 90):.3f} max {last50.max():.3f} "
        f"num_fragments={frags[-1]} settled_profile={trainer.fragment_profile!r}")
    log(f"[train] step_ms_all={[round(x * 1e3, 2) for x in step_s]}")
    return trainer, batch_for, launches, iterations


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "workloads",
              "host_load1")


def check_bench_point(name, point):
    """The four kernels against their plain versions on frame 0 of one
    bench point's state as its timed windows left it, at the fragment
    profile it settled at: with more than one sort band, expand and segsum
    on every band and the tile kernels on the bands' concatenated records
    (`kernel_check.check_bands`), as the trainer renders them. Requires
    that nothing is dropped. Returns {kernel: max_abs_err}."""
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render.binning import tile_grid
    from rodygs_tpu_torch.render.compact import split_profile
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    tr = point.trainer
    st, W, H = tr.state, tr.cfg.image_width, tr.cfg.image_height
    tx, ty = tile_grid(W, H)
    profile, bands = split_profile(tr.fragment_profile)
    args = (st.store.params, st.store.alive,
            make_camera_from_poses(st.poses, point.batch_for(0)),
            tr.active_sh_degree, W, H, profile, _default_tight(tx * ty))
    if bands > 1:
        errs, cb = KC.check_bands(*args, bands, seed=8)
    else:
        s = KC.capture_stages(*args, 8)
        errs, cb = KC.check_stages(s), s["cb"]
    log(f"[bench] check on frame 0 of {name}'s timed state at profile "
        f"{tr.fragment_profile!r} ({bands} band(s)): fragments "
        f"{int(cb.num_fragments)}, dropped {int(cb.dropped)}, "
        f"max_abs_err={errs}")
    require(int(cb.dropped) == 0,
            f"bench {name}: the check's binning dropped {int(cb.dropped)} "
            f"fragments at {tr.fragment_profile!r}")
    return errs


def phase_bench(device):
    """Phase 3a: `tools/bench.py`'s main in this process at both of its
    points; its JSON line printed here. Requires bench.py's keys, a finite
    value above 0, no error and at least one steady window at each point
    and every kernel launched in each point's timed windows (the tool sets
    the counts to 0 just before its windows and reads them just after).
    Then the four kernels against their plain versions on frame 0 of each
    point's timed state (`check_bench_point`). Returns ({workload:
    {kernel: launches}}, {kernel: max_abs_err})."""
    import contextlib
    import io
    import torch
    from rodygs_tpu_torch.tools import bench as B

    t_phase = time.perf_counter()
    out, points = io.StringIO(), {}
    with contextlib.redirect_stdout(out):
        rc = B.main(["--device", device.type], points=points)
    lines = out.getvalue().strip().splitlines()
    log(f"[bench] tools/bench.py exit code {rc} "
        f"({time.perf_counter() - t_phase:.2f} s), on {lines[-2]}:")
    log(lines[-1])
    line = json.loads(lines[-1])
    require(rc == 0, f"tools/bench.py: exit code {rc}")
    require(tuple(line) == BENCH_KEYS, f"bench line keys {list(line)}")
    require(math.isfinite(line["value"]) and line["value"] > 0,
            f"bench value {line['value']}")
    names = [B.workload_name(p["W"], p["H"], p["N"])
             for p in (B.HEADLINE, B.FLAGSHIP)]
    require(list(line["workloads"]) == names,
            f"bench workloads {list(line['workloads'])}")
    launches, errs = {}, {}
    for name, w in line["workloads"].items():
        require("error" not in w, f"bench {name}: {w.get('error')}")
        require(w["n_steady"] >= 1, f"bench {name}: no steady window")
        launches[name] = points[name].launches
        log(f"[bench] {name}: step_ms {w['step_ms']} ({w['n_steady']} of "
            f"{len(w['windows_ms'])} windows steady), profile "
            f"{w['fragment_profile']}, launches in the timed windows "
            f"{launches[name]}")
        require(all(launches[name][k] > 0 for k in SOURCES),
                f"bench {name}: a kernel never launched in the windows "
                f"{launches[name]}")
        for k, v in check_bench_point(name, points[name]).items():
            errs[k] = max(errs.get(k, 0.0), v)
    del points
    torch.cuda.empty_cache()
    log(f"[bench] phase {time.perf_counter() - t_phase:.2f} s")
    return launches, errs


# the variants phase: the oracle scene, the sparse-Adam run, timing reps
ORACLE_N, ORACLE_SIZE = 2000, 256
SPARSE_STEPS = 50
VARIANT_REPS = 20
OUT_KEYS = ("rendered_image", "rendered_depth", "rendered_alpha",
            "rendered_normal")


def _image_tol(key):
    return 2e-4 if key in ("rendered_depth", "rendered_normal") else 2e-5


def _tile_pixels(tiles, tiles_x, width, height, device):
    """[H, W] bool: the pixels of the given tile ids."""
    import torch

    ys = torch.arange(height, device=device) // 16
    xs = torch.arange(width, device=device) // 16
    tid = ys[:, None] * tiles_x + xs[None, :]
    return torch.isin(tid, tiles)


def _render_grads(params, alive, cam, sh, width, height, weights, **kw):
    """render() forward and backward under a fixed linear loss (seeded
    weights on image, depth and alpha: the cotangent does not depend on the
    output); the outputs and the gradients of the six parameter tensors."""
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.rasterize import render

    leaves = [x.detach().clone().requires_grad_(True) for x in params]
    q = type(params)(*leaves)
    out = render(q.xyz, G.get_features(q), G.get_opacity(q), G.get_scaling(q),
                 q.rotation, cam, sh, width, height, alive=alive, **kw)
    sum((out[k] * w).sum() for k, w in weights.items()).backward()
    return ({k: v.detach() if hasattr(v, "detach") else v
             for k, v in out.items()}, [x.grad for x in leaves])


def _scaled(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def phase_variants(device, trainer, batch_for):
    """The render variants on the static bench's trained state at 512^2
    (phase 3b): the legacy path end to end (launches counted), its
    binning's order against the compact one's, the tile kernels on the
    legacy records against their plain versions, the legacy reduction
    against segsum, the legacy render on the card against the CPU, the bf16
    payload and the gather strategies, the dense oracle, 50 steps of the
    row-sparse camera Adam, and the render times. Returns
    (launches_legacy, launches_variants, {kernel: max_abs_err},
    {kernel: legacy-layout ms})."""
    import contextlib

    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render import rasterize as R
    from rodygs_tpu_torch.render import tile_kernel as TK
    from rodygs_tpu_torch.render.composite_ref import composite_reference
    from rodygs_tpu_torch.render.preprocess import preprocess
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    t_phase = time.perf_counter()
    st = trainer.state
    params, alive = st.store.params, st.store.alive
    cam = make_camera_from_poses(st.poses, batch_for(0))
    sh = trainer.active_sh_degree
    W = H = int(trainer.cfg.image_width)
    tx = -(-W // 16)
    n = params.xyz.shape[0]
    wide = C.fragment_capacity(n, "wide")
    gen = torch.Generator(device=device).manual_seed(23)
    weights = {"rendered_image": torch.randn((H, W, 3), generator=gen,
                                             device=device),
               "rendered_depth": torch.randn((H, W), generator=gen,
                                             device=device),
               "rendered_alpha": torch.randn((H, W), generator=gen,
                                             device=device)}
    rg = lambda **kw: _render_grads(params, alive, cam, sh, W, H, weights,
                                    **kw)
    errs = {}

    # the legacy path end to end: its launches alone
    torch.cuda.synchronize()
    kernels.reset_launches()
    out_l, g_l = rg(binning_mode="legacy")
    torch.cuda.synchronize()
    launches_legacy = dict(kernels.LAUNCHES)
    log(f"[variants] legacy render fwd+bwd at {W}x{H}: fragments="
        f"{int(out_l['num_fragments'])} overflow={bool(out_l['overflow'])} "
        f"dropped={int(out_l['dropped'])}; launches {launches_legacy}")
    require(launches_legacy["tile_fwd"] >= 1 and launches_legacy["tile_bwd"] >= 1,
            f"the legacy path launched no tile kernel: {launches_legacy}")
    require(launches_legacy["expand"] == 0 and launches_legacy["segsum"] == 0,
            f"the legacy path launched a compact kernel: {launches_legacy}")
    require(not bool(out_l["overflow"]) and int(out_l["dropped"]) == 0,
            "the legacy binning overflows at 'lean'")
    require(all(bool(torch.isfinite(g).all()) for g in g_l)
            and float(g_l[0].abs().max()) > 0,
            "legacy gradients not finite or zero")

    # the compact path over the same circle rects, and the two orders
    out_c, g_c = rg(tight_rect=False, fragment_profile="wide")
    require(int(out_c["dropped"]) == 0, "the compact render drops at 'wide'")
    require(int(out_c["num_fragments"]) == int(out_l["num_fragments"]),
            "legacy and compact fragment counts differ")
    s = KC.capture_legacy(params, alive, cam, sh, W, H)
    order = KC.legacy_order(s, wide)
    re_tiles = order["reordered"]
    n_tiles = s["binning"].tile_counts.shape[0]
    same = ~_tile_pixels(re_tiles, tx, W, H, params.xyz.device)
    diff = {k: float((out_l[k] - out_c[k]).abs().max()) for k in OUT_KEYS}
    for k in OUT_KEYS:
        require(torch.equal(out_l[k][same], out_c[k][same]),
                f"legacy {k} differs from compact on a tile of equal order")
    log(f"[variants] legacy vs compact forward (circle rects): bit-identical "
        f"on the {n_tiles - re_tiles.numel()} of {n_tiles} tiles whose "
        f"fragment order agrees; the other {re_tiles.numel()} differ in "
        f"order only where two depths share their {C.depth_key_bits(tx, tx)} "
        f"key bits ({order['tie_pairs']} adjacent tied pairs among "
        f"{order['fragments']} fragments; the legacy sort takes float32 "
        f"depth, the compact key the quantized depth with ties in gaussian "
        f"order), max |diff| there {diff}")
    log("[variants] legacy vs compact render() gradients, max |diff| / max: "
        + " ".join(f"{_scaled(a, b):.3g}" for a, b in zip(g_l, g_c)))

    # the legacy records in the compact order are the compact's records
    sc = KC.capture_stages(params, alive, cam, sh, W, H, "wide", False, 5,
                           include_normal=True)
    total = order["fragments"]
    perm = order["order"]
    rec_l = s["records"][:, perm]
    require(torch.equal(rec_l, sc["records"][:, :total]),
            "the legacy records in compact order differ from the compact "
            "path's sorted records")
    log(f"[variants] the legacy gather's records, put in the compact order, "
        f"equal the compact path's sorted records ({total} columns)")

    # the tile kernels on the legacy layout against their plain versions
    b = s["binning"]
    e = KC.check_tiles(s["records"], b.tile_starts, b.tile_counts, s["off"],
                       tx, True)
    errs.update(e)
    log(f"[variants] tile kernels on the legacy records (P="
        f"{s['records'].shape[1]}, a multiple of 128, {R.DUMMY_COLS} zero "
        f"dummy columns, row 13 = 1): max_abs_err={e}; backward twice: "
        f"equal bits")

    # the legacy reduction (the gather's backward, index_add_) against
    # segsum, on the compact backward's per-fragment gradients
    d_rec = TK.rasterize_bwd_impl(sc["records"], sc["cb"].tile_starts,
                                  sc["cb"].tile_counts, sc["off"], sc["out"],
                                  sc["gout"], tx, True)
    d_leg = torch.zeros_like(s["records"])
    d_leg[:, perm] = d_rec[:, :total]
    with torch.enable_grad():
        leaf = R._pack_records(s["splats"]).requires_grad_(True)
        leaf.index_select(1, b.padded_gid).backward(d_leg)
    seg = C.segment_sum_rows(sc["d_presort"], sc["table"], sc["cb"].bases,
                             sc["cb"].f_kept)[:, :n]
    red = leaf.grad[:C.NUM_REC_ROWS, :n]
    e_red = float((red - seg).abs().max())
    rel = e_red / max(float(seg.abs().max()), 1e-30)
    log(f"[variants] legacy reduction (index_add_) vs segsum on the same "
        f"fragment gradients: max |diff| {e_red:.3g}, scaled {rel:.3g} (bar "
        f"{KC.TOL_SEGSUM_SCALED}); equal elements "
        f"{100 * float((red == seg).double().mean()):.2f}%")
    require(rel <= KC.TOL_SEGSUM_SCALED, "legacy reduction differs from segsum")
    errs["segsum"] = e_red

    # the legacy render on the card against the CPU (plain versions)
    p5, cam5 = KC.random_scene(5000, 3, device)
    w5 = {k: v[:128, :128].contiguous() for k, v in weights.items()}
    gpu = _render_grads(p5, None, cam5, 3, 128, 128, w5,
                        binning_mode="legacy")
    cpu = _render_grads(type(p5)(*[x.cpu() for x in p5]), None,
                        type(cam5)(*[x.cpu() for x in cam5]), 3, 128, 128,
                        {k: v.cpu() for k, v in w5.items()},
                        binning_mode="legacy")
    e_img = {k: float((gpu[0][k].cpu() - cpu[0][k]).abs().max())
             for k in OUT_KEYS}
    e_grad = [_scaled(a.cpu(), b) for a, b in zip(gpu[1], cpu[1])]
    log(f"[variants] legacy render 128x128 n=5000 cuda vs cpu: {e_img}; "
        f"gradients scaled {[f'{x:.3g}' for x in e_grad]}")
    require(all(e_img[k] <= (2e-4 if k in ("rendered_depth",
                                           "rendered_normal") else 1e-4)
                for k in OUT_KEYS), "legacy render cuda vs cpu")
    require(max(e_grad) <= KC.TOL_BWD_SCALED, "legacy gradients cuda vs cpu")

    # the compact variants on the trainer's own render
    prof = trainer.fragment_profile
    kw = dict(fragment_profile=prof, include_normal=False)

    @contextlib.contextmanager
    def knob(name, value):
        old = getattr(R, name)
        setattr(R, name, value)
        try:
            yield
        finally:
            setattr(R, name, old)

    torch.cuda.synchronize()
    kernels.reset_launches()
    base = rg(**kw)
    bf16 = rg(bf16_records=True, **kw)
    with knob("_BWD_UNSORT", "gather"):
        g_unsort = rg(**kw)
    with knob("_FWD_RECORDS", "gather"):
        g_records = rg(**kw)
    torch.cuda.synchronize()
    launches_variants = dict(kernels.LAUNCHES)
    log(f"[variants] bf16 / gather-unsort / gather-records renders "
        f"(profile {prof!r}): launches {launches_variants}")
    require(all(launches_variants[k] > 0 for k in kernels.KERNELS),
            f"a kernel never launched in the variants: {launches_variants}")
    e_bf = float((bf16[0]["rendered_image"]
                  - base[0]["rendered_image"]).abs().max())
    g_bf = max(_scaled(a, b) for a, b in zip(bf16[1], base[1]))
    log(f"[variants] bf16 payload vs float32: image {e_bf:.3g} (bar 1e-2), "
        f"gradients scaled {g_bf:.3g} (bar 3e-2)")
    require(e_bf < 1e-2 and g_bf < 3e-2, "bf16 payload off its envelope")
    for name, (o, g) in (("gather unsort", g_unsort),
                         ("gather records", g_records)):
        require(all(torch.equal(o[k], base[0][k]) for k in OUT_KEYS)
                and all(torch.equal(a, b) for a, b in zip(g, base[1])),
                f"{name} differs from sort")
    log("[variants] gather unsort and gather records: outputs and gradients "
        "bit-identical to sort")

    # the dense oracle on a scene small enough for it
    po, camo = KC.random_scene(ORACLE_N, 11, device)
    args = (po.xyz, G.get_features(po), G.get_opacity(po), G.get_scaling(po),
            po.rotation)
    with torch.no_grad():
        sp = preprocess(po.xyz, G.get_scaling(po), po.rotation,
                        G.get_opacity(po), G.get_features(po), 3, camo,
                        ORACLE_SIZE, ORACLE_SIZE)
        ref = composite_reference(sp, ORACLE_SIZE, ORACLE_SIZE)
        leg = R.render(*args, camo, 3, ORACLE_SIZE, ORACLE_SIZE,
                       binning_mode="legacy")
        com = R.render(*args, camo, 3, ORACLE_SIZE, ORACLE_SIZE,
                       fragment_profile="wide")
        so = KC.capture_legacy(po, None, camo, 3, ORACLE_SIZE, ORACLE_SIZE)
        o_order = KC.legacy_order(so, C.fragment_capacity(ORACLE_N, "wide"))
    require(not bool(leg["overflow"]) and int(com["dropped"]) == 0,
            "the oracle scene overflows")
    txo = -(-ORACLE_SIZE // 16)
    tied = _tile_pixels(o_order["reordered"], txo, ORACLE_SIZE, ORACLE_SIZE,
                        device)
    e_leg = {k: float((leg[k] - ref[k]).abs().max()) for k in OUT_KEYS}
    e_com = {k: float((com[k] - ref[k])[~tied].abs().max()) for k in OUT_KEYS}
    e_tied = {k: float((com[k] - ref[k])[tied].abs().max()) if bool(tied.any())
              else 0.0 for k in OUT_KEYS}
    log(f"[variants] dense oracle {ORACLE_SIZE}x{ORACLE_SIZE} n={ORACLE_N}: "
        f"legacy render {e_leg}; compact render off the "
        f"{o_order['reordered'].numel()} tiles where quantized-depth ties "
        f"reorder it {e_com}, on them {e_tied}")
    require(all(e_leg[k] <= _image_tol(k) for k in OUT_KEYS),
            "legacy render differs from the dense oracle")
    require(all(e_com[k] <= _image_tol(k) for k in OUT_KEYS),
            "compact render differs from the dense oracle")
    del ref, sp, so

    # the row-sparse camera Adam over 50 steps
    sparse, sparse_batch, _ = bench_trainer(
        device, size=W, N=int(alive.sum()), capacity=n,
        camera_sparse_adam=True)
    moved = []
    for it in range(1, SPARSE_STEPS + 1):
        b_it = sparse_batch(it - 1)
        f = b_it.frame_idx
        before = sparse.state
        m = sparse.train_iteration(b_it, it)
        after = sparse.state
        require(math.isfinite(float(m["loss"])), "sparse Adam: loss")
        rows = torch.arange(after.cam_opt.count.shape[0], device=device) != f
        require(torch.equal(after.cam_opt.count[rows],
                            before.cam_opt.count[rows])
                and int(after.cam_opt.count[f]) == int(before.cam_opt.count[f]) + 1,
                f"sparse Adam step {it}: counts {after.cam_opt.count.tolist()}")
        for tree in ("poses", "mu", "nu"):
            a = (after.poses if tree == "poses"
                 else getattr(after.cam_opt, tree))
            bb = (before.poses if tree == "poses"
                  else getattr(before.cam_opt, tree))
            require(all(torch.equal(x[rows], y[rows]) for x, y in zip(a, bb)),
                    f"sparse Adam step {it}: {tree} of another frame moved")
        moved.append(max(float((x[f] - y[f]).abs().max())
                         for x, y in zip(after.poses, before.poses)))
    require(min(moved) > 0, "sparse Adam: the batch frame's pose never moved")
    log(f"[variants] row-sparse camera Adam, {SPARSE_STEPS} steps: only the "
        f"batch frame's pose row, moments and count moved each step; counts "
        f"{sparse.state.cam_opt.count.tolist()}; batch-row |dpose| min "
        f"{min(moved):.3g} max {max(moved):.3g}")
    del sparse

    # render times, forward and backward, synchronised medians
    def median_ms(**kw_):
        ts = []
        for _ in range(VARIANT_REPS + 2):
            t = time.perf_counter()
            rg(**kw_)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return float(np.median(ts[2:]))

    times = {"legacy 'lean'": median_ms(binning_mode="legacy"),
             f"compact {prof!r} (the trainer's)": median_ms(**kw),
             "compact 'wide' circle rects": median_ms(
                 tight_rect=False, fragment_profile="wide")}
    out_leg = TK.rasterize_fwd_impl(s["records"], b.tile_starts,
                                    b.tile_counts, s["off"], tx)
    legacy_ms = {
        "tile_fwd": time_ms(lambda: TK.rasterize_fwd_impl(
            s["records"], b.tile_starts, b.tile_counts, s["off"], tx)),
        "tile_bwd": time_ms(lambda: TK.rasterize_bwd_impl(
            s["records"], b.tile_starts, b.tile_counts, s["off"], out_leg,
            sc["gout"], tx))}
    smi = card_name_and_limit()
    log(f"[variants] render fwd+bwd at {W}x{H}, median of {VARIANT_REPS} "
        f"synchronised: " + " ".join(f"{k} {v:.3f} ms" for k, v in
                                      times.items())
        + f"; tile kernels on the legacy records: tile_fwd "
        f"{legacy_ms['tile_fwd']:.4f} ms, tile_bwd {legacy_ms['tile_bwd']:.4f}"
        f" ms (with its zero fill of [16, {s['records'].shape[1]}]); card "
        f"{smi}")
    log(f"[variants] phase {time.perf_counter() - t_phase:.2f} s")
    return launches_legacy, launches_variants, errs, legacy_ms


def fragment_op(name, shapes, cap):
    """Which fragment-scale step of `composite_compact` an operator with
    these input shapes belongs to, or None: the operators that touch a
    [*, capacity] tensor between the four kernels."""
    def dims(x):
        if isinstance(x, (list, tuple)):
            if x and all(isinstance(v, int) for v in x):
                yield tuple(x)
            else:
                for v in x:
                    yield from dims(v)

    shaped = [d for d in dims(shapes) if d and d[-1] == cap]
    if not shaped:
        return None
    if name.startswith("aten::sort"):
        return "torch.sort (stable, int32 keys)"
    if name in ("aten::index_put_", "aten::_index_put_impl_"):
        return "unsort scatter d_presort[:, perm] = d_records"
    if name == "aten::index":
        return "record gather rec[:, perm]"
    if name == "aten::cat":
        return "stack_records (cat and its constant rows)"
    if name == "aten::fill_":
        if shaped[0][0] == 16:
            return "zero fill of d_records in tile_bwd's wrapper"
        return "stack_records (cat and its constant rows)"
    return f"other: {name}"


def dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


# record_function ranges of the port; on the device timeline they repeat the
# time of the kernels inside them, so they are left out of the busy sum
RANGES = ("motion_mlp", "rigidity_knn", "densify_and_prune")


def device_summary(prof, steps, wall_ms, tag, top=14):
    """The device's busy ms per step (self time of the device events) and
    its share of `wall_ms`, and the top device operators."""
    import torch

    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0 and e.key not in RANGES]
    total_ms = sum(dev_us(e) for e in events) / 1e3 / steps
    require(total_ms > 0, "the profiler saw no device time")
    log(f"[{tag}] {steps} steps: wall {wall_ms:.3f} ms/step (profiler on), "
        f"device busy {total_ms:.3f} ms/step = "
        f"{100 * total_ms / wall_ms:.1f}% of wall")
    ours = ("expand_kernel", "tile_fwd_kernel", "tile_bwd_kernel",
            "segsum_kernel")
    ranked = sorted(events, key=dev_us, reverse=True)
    for e in ranked[:top] + [e for e in ranked[top:]
                             if any(k in e.key for k in ours)]:
        ms = dev_us(e) / 1e3 / steps
        log(f"[{tag}]   {ms:8.4f} ms/step {100 * ms / total_ms:5.1f}%  "
            f"x{e.count // steps:<4d} {e.key[:90]}")
    return total_ms


def range_device_ms(prof, name):
    """Device time of the kernels launched inside a record_function range
    (summed over its calls), and the number of calls."""
    import torch

    hits = [e for e in prof.key_averages() if e.key == name
            and e.device_type == torch.autograd.DeviceType.CPU]
    if not hits:
        return 0.0, 0
    return (sum(getattr(e, "device_time_total", 0.0) for e in hits) / 1e3,
            sum(e.count for e in hits))


def phase_profile(trainer, batch_for, first_iteration, cap, steps=5):
    """torch.profiler over a few steps: device time by kernel/op (self
    time, per step), the device's busy share of the wall time, and the
    device time of the fragment-scale operators around the four kernels
    (`fragment_op`; `cap` is the fragment capacity their shapes carry)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()   # after the profiler's own start-up
        for it in range(first_iteration, first_iteration + steps):
            trainer.train_iteration(batch_for(it - 1), it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_summary(prof, steps, wall_ms, "profile")
    # the operators between the kernels, by the shapes they were called with
    groups = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type == torch.autograd.DeviceType.CUDA or dev_us(e) <= 0:
            continue
        group = fragment_op(e.key, e.input_shapes, cap)
        if group is not None:
            ms, n = groups.get(group, (0.0, 0))
            groups[group] = (ms + dev_us(e) / 1e3 / steps, n + e.count)
    require(groups, "the profiler attributed no device time to the "
                    "fragment-scale operators")
    for group, (ms, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
        log(f"[profile]   fragment-scale {ms:8.4f} ms/step x{n // steps:<3d} "
            f"{group}")


# --------------------------------------------------------------------------
# the joint RoDyGS iteration
# --------------------------------------------------------------------------

# configs/train/train_kubric_mrig.yaml:103-239, the trainer block, spelled
# out so the phase reads no config file. Changed from the file: the image size, the
# store sizes and the iteration window (JOINT_REDUCED).
KUBRIC_STATIC_LOSSES = [
    {"name": "d_ssim", "weight": 0.2, "target": "src.trainer.losses.SSIMLoss",
     "params": {"mode": "all"}},
    {"name": "l1", "weight": 0.8, "target": "src.trainer.losses.L1Loss",
     "params": {"mode": "all"}},
    {"name": "global_pearson_depth", "weight": 0.05, "start": 0,
     "target": "src.trainer.losses.GlobalPearsonDepthLoss",
     "params": {"mode": "all"}},
    {"name": "local_pearson_depth", "weight": 0.15, "start": 0,
     "target": "src.trainer.losses.LocalPearsonDepthLoss",
     "params": {"box_p": 128, "p_corr": 0.5, "mode": "all"}},
]
KUBRIC_DYNAMIC_LOSSES = KUBRIC_STATIC_LOSSES[:2] + [
    {"name": "motion_l1_reg", "weight": 0.01, "start": 0,
     "target": "src.trainer.losses.MotionL1Loss"},
    {"name": "motion_sparsity", "weight": 0.002, "start": 0,
     "target": "src.trainer.losses.MotionSparsityLoss"},
    {"name": "rigidity", "weight": 0.5, "freq": 5, "start": 0,
     "target": "src.trainer.losses.RigidityLoss",
     "params": {"mode": ["distance_preserving", "surface"], "K": 8}},
    {"name": "motion_basis_reg", "weight": 0.1, "start": 0,
     "target": "src.trainer.losses.MotionBasisRegularizaiton",
     "params": {"transl_degree": 0, "rot_degree": 0,
                "freq_div_mode": "cum_exponential"}},
    KUBRIC_STATIC_LOSSES[3],
]
KUBRIC_STATIC = dict(
    num_iterations=20000, position_lr_init=0.00016, position_lr_final=1.6e-06,
    position_lr_delay_mult=0.01, position_lr_max_steps=20000, feature_lr=0.0025,
    opacity_lr=0.05, scaling_lr=0.005, rotation_lr=0.001, percent_dense=0.01,
    densification_interval=100, opacity_reset_interval=5000000,
    densify_from_iter=500, densify_until_iter=20000,
    densify_grad_threshold=0.0002, camera_rotation_lr=1.0e-05,
    camera_translation_lr=1.0e-06, camera_lr_warmup=0,
    camera_total_steps=20000, sh_degree=3)
KUBRIC_DYNAMIC = dict(
    KUBRIC_STATIC, scaling_lr=0.001, densify_until_iter=15000,
    deform_warmup_steps=0, deform_lr_init=0.0016, deform_lr_final=0.00016,
    deform_lr_delay_mult=0.01, deform_lr_max_steps=20000,
    motion_coeff_lr=0.00016, camera_rotation_lr=0.0, camera_translation_lr=0.0,
    deform_netwidth=128, deform_t_emb_multires=26,
    deform_t_log_sampling=False, num_basis=16, isotropic=False,
    inverse_motion=True)
KUBRIC_JOINT = dict(sh_up_start_iteration=15000, sh_up_period=1000)
JOINT_ITERATIONS = (481, 640)   # both models densify at 600
JOINT_REDUCED = ("image 512x512 (kubric frames are larger)",
                 "static store 100,000 in 131,072 slots, dynamic 24,000 in "
                 "32,768, seeded (no point cloud files)",
                 "iterations 481-640 of 20,000, from a fresh optimiser state")


def joint_trainer(device, size=512, n_static=100_000, cap_static=131072,
                  n_dyn=24_000, cap_dyn=32768, n_objects=6, n_frames=8,
                  mesh=None):
    """The joint scene: the bench static set (its GT too), and n_dyn
    dynamic gaussians in n_objects blobs born at t = 0, each blob moving
    with a seeded velocity. GT images and depths are rendered by the port
    from the GT static set plus the moved GT dynamic set on the 8-frame
    +-0.2 rad arc at times i/7; the image gets N(0, 0.05) noise, the depth
    a seeded affine distortion and N(0, 0.05) (the Pearson terms are
    scale-invariant); the motion mask is the dynamic set's alone alpha >
    0.5. The dynamic model starts from the frame-0 positions and colours
    through `from_point_cloud` (KNN scale prior, opacity 0.1)."""
    import torch
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.camera import make_camera
    from rodygs_tpu_torch.render.rasterize import render
    from rodygs_tpu_torch.train.losses import MultiLoss
    from rodygs_tpu_torch.train.optim import CameraPoses
    from rodygs_tpu_torch.train.trainer_dynamic import (DynTrainer,
                                                        DynTrainerConfig)
    from rodygs_tpu_torch.train.trainer_joint import RoDyGSTrainer
    from rodygs_tpu_torch.train.trainer_static import (
        FrameBatch, StaticTrainerConfig, ThreeDGSTrainer)

    W = H = size
    fov = 0.9
    rng = np.random.default_rng(7)
    pts = rng.uniform([-2.0, -2.0, 2.5], [2.0, 2.0, 7.0],
                      size=(n_static, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, size=(n_static, 3)).astype(np.float32)
    static = G.from_point_cloud(pts, cols, sh_degree=3, capacity=cap_static,
                                device=device)
    scales = np.exp(rng.uniform(-4.0, -2.6, size=(cap_static, 3)))
    static = static._replace(params=static.params._replace(
        scaling=torch.tensor(np.log(scales), dtype=torch.float32,
                             device=device)))

    drng = np.random.default_rng(13)
    obj = drng.integers(0, n_objects, n_dyn)
    centres = drng.uniform([-1.0, -1.0, 3.0], [1.0, 1.0, 4.5], (n_objects, 3))
    vel = drng.uniform(-0.3, 0.3, (n_objects, 3))
    base = drng.uniform(0.1, 0.9, (n_objects, 3))
    dpts = (centres[obj] + drng.normal(0, 0.15, (n_dyn, 3))).astype(np.float32)
    dcols = np.clip(base[obj] + drng.normal(0, 0.05, (n_dyn, 3)),
                    0.05, 0.95).astype(np.float32)
    dyn = G.from_point_cloud(dpts, dcols, sh_degree=3, capacity=cap_dyn,
                             times=np.zeros(n_dyn, np.float32), device=device)
    gt_dyn = dyn.params._replace(
        scaling=torch.full_like(dyn.params.scaling, math.log(0.02)),
        opacity=torch.full_like(dyn.params.opacity, math.log(0.9 / 0.1)))
    vel_t = torch.zeros((cap_dyn, 3), device=device)
    vel_t[:n_dyn] = torch.tensor(vel[obj], dtype=torch.float32, device=device)

    qs, ts = [], []
    for ang in np.linspace(-0.2, 0.2, n_frames):
        qs.append([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        ts.append([np.sin(ang) * 4.0, 0, 0])
    poses = CameraPoses(
        q_c2w=torch.tensor(qs, dtype=torch.float32, device=device),
        t_c2w=torch.tensor(ts, dtype=torch.float32, device=device))
    times = [i / (n_frames - 1) for i in range(n_frames)]

    def draw(p, alive, cam):
        return render(p.xyz, G.get_features(p), G.get_opacity(p),
                      G.get_scaling(p), p.rotation, cam, 3, W, H, alive=alive)

    @torch.no_grad()
    def gt_render(cam, t):
        """The GT static set plus the GT dynamic set moved to time t."""
        moved = gt_dyn._replace(xyz=gt_dyn.xyz + vel_t * t)
        both = G.GaussianParams(*[torch.cat(x)
                                  for x in zip(static.params, moved)])
        return draw(both, torch.cat([static.alive, dyn.alive]), cam), moved

    gt_rng = np.random.default_rng(11)
    frames = []
    with torch.no_grad():
        for i, t in enumerate(times):
            cam = make_camera(poses.q_c2w[i], poses.t_c2w[i], fov, fov, t,
                              device=device)
            out, moved = gt_render(cam, t)
            img = out["rendered_image"].cpu().numpy()
            img = np.clip(img + gt_rng.normal(0, 0.05, img.shape), 0.0, 1.0)
            depth = out["rendered_depth"].cpu().numpy()
            depth = 1.7 * depth + 0.3 + gt_rng.normal(0, 0.05, depth.shape)
            mask = draw(moved, dyn.alive, cam)["rendered_alpha"] > 0.5
            frames.append(FrameBatch(
                gt_image=torch.tensor(img, dtype=torch.float32, device=device),
                gt_depth=torch.tensor(depth, dtype=torch.float32, device=device),
                motion_mask=mask.to(torch.float32), frame_idx=i,
                time=torch.tensor(t, device=device),
                fovx=torch.tensor(fov, device=device),
                fovy=torch.tensor(fov, device=device)))

    s_cfg = StaticTrainerConfig(image_width=W, image_height=H, **KUBRIC_STATIC)
    d_cfg = DynTrainerConfig(image_width=W, image_height=H, **KUBRIC_DYNAMIC)
    st = ThreeDGSTrainer(s_cfg, MultiLoss.from_config(KUBRIC_STATIC_LOSSES),
                         static, poses, spatial_lr_scale=4.0, device=device,
                         seed=1, mesh=mesh)
    dt = DynTrainer(d_cfg, MultiLoss.from_config(KUBRIC_DYNAMIC_LOSSES), dyn,
                    spatial_lr_scale=4.0, seed=2, device=device, mesh=mesh)
    joint = RoDyGSTrainer(st, dt, mesh=mesh, **KUBRIC_JOINT)
    gt_poses = CameraPoses(*[x.clone() for x in poses])
    return joint, (lambda i: frames[i % n_frames]), (W, H), (gt_render,
                                                            gt_poses)


def _alive(trainer):
    from rodygs_tpu_torch.models import gaussians as G

    return int(G.num_alive(trainer.state.store))


def check_concatenated(joint, batch, width, height, tag, seed):
    """The four kernels against their plain versions on the render the
    joint trainer's dynamic step makes of `batch`: the static set and the
    deformed dynamic set, concatenated, at the dynamic fragment profile.
    Returns ({kernel: max_abs_err}, the captured stages)."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render import tile_kernel as TK
    from rodygs_tpu_torch.render.binning import tile_grid
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    st, dyn = joint.static, joint.dynamic
    with torch.no_grad():
        p = dyn.params()
        transl, rot_delta = dyn.deformation(p, batch.time,
                                            dyn.state.store.time_ind)
        sp, gp = st.state.store.params, p.gauss
        cat = G.GaussianParams(
            xyz=torch.cat([sp.xyz, gp.xyz + transl]),
            features_dc=torch.cat([sp.features_dc, gp.features_dc]),
            features_rest=torch.cat([sp.features_rest, gp.features_rest]),
            scaling=torch.cat([sp.scaling, gp.scaling]),
            rotation=torch.cat([G.get_rotation(sp),
                                G.get_rotation(gp) + rot_delta]),
            opacity=torch.cat([sp.opacity, gp.opacity]))
    alive = torch.cat([st.state.store.alive, dyn.state.store.alive])
    tx, ty = tile_grid(width, height)
    s = KC.capture_stages(cat, alive, make_camera_from_poses(st.state.poses,
                                                             batch),
                          dyn.active_sh_degree, width, height,
                          joint.dyn_fragment_profile,
                          _default_tight(tx * ty), seed)
    errs = KC.check_stages(s)
    sl = KC.slot_stats(s)
    cb = s["cb"]
    with torch.no_grad():   # the scales the two scaled bars divide by
        d_rec = TK.rasterize_bwd_impl(s["records"], cb.tile_starts,
                                      cb.tile_counts, s["off"], s["out"],
                                      s["gout"], s["tx"], s["include_normal"])
        seg = C.segment_sum_rows(s["d_presort"], s["table"], cb.bases,
                                 cb.f_kept)
    scale = {"tile_bwd": float(d_rec.abs().max()),
             "segsum": float(seg.abs().max())}
    log(f"[{tag}] check on frame {batch.frame_idx}'s concatenated render: "
        f"{G.capacity_of(st.state.store)} + {G.capacity_of(dyn.state.store)} "
        f"gaussians, C={sl['capacity']} f_kept={sl['f_kept']} "
        f"fragments={int(cb.num_fragments)} max_abs_err={errs}; "
        + ", ".join(f"{k} max |output| {v:.6g}, error / max "
                    f"{errs[k] / v:.3g}" for k, v in scale.items()))
    return errs, s


def phase_joint(device, **scene):
    """Joint iterations 481-640 (static step, static densify, dynamic step,
    dynamic densify) on the joint scene; checks, then the kernels on the
    concatenated render of frame 0, then the profiler (5 more iterations).
    Returns ({kernel: launches}, {kernel: max_abs_err}, the end state:
    dict(joint, gt_render, gt_poses, size, iteration))."""
    import torch
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render import compact as C

    t_phase = time.perf_counter()
    joint, batch_for, (W, H), (gt_render, gt_poses) = joint_trainer(
        device, **scene)
    torch.cuda.synchronize()
    log(f"[joint] set-up {time.perf_counter() - t_phase:.2f} s; reduced from "
        f"the config: {'; '.join(JOINT_REDUCED)}")
    st, dyn = joint.static, joint.dynamic
    coeff0 = dyn.state.motion_coeff.clone()
    net0 = {k: v.clone() for k, v in dyn.state.net["timenet"].items()}

    step_s = {"static": [], "dynamic": []}

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            step_s[key].append(time.perf_counter() - t)
            return out
        return run

    st.step = timed(st.step, "static")
    joint.dyn_step = timed(joint.dyn_step, "dynamic")
    first, last = JOINT_ITERATIONS
    losses = {"static": [], "dynamic": []}
    joint_s, densified, m = [], {}, None
    overflowed = {"static": [], "dynamic": []}
    kernels.reset_launches()
    for it in range(first, last + 1):
        before = (_alive(st), _alive(dyn))
        if it == 600:
            for name, tr in (("static", st), ("dynamic", dyn)):
                sts, on = tr.state.stats, tr.state.store.alive
                g = (sts.grad_accum / sts.denom.clamp(min=1))[on]
                q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99],
                                                   device=g.device))
                log(f"[joint] {name} mean screen grad before 600: p50 "
                    f"{float(q[0]):.3g} p90 {float(q[1]):.3g} p99 "
                    f"{float(q[2]):.3g}, share >= threshold "
                    f"{float((g >= tr.cfg.densify_grad_threshold).float().mean()):.4f}")
        t = time.perf_counter()
        m = joint.train_iteration(batch_for(it - 1), batch_for(it - 1), it)
        torch.cuda.synchronize()
        joint_s.append(time.perf_counter() - t)
        for k in losses:
            losses[k].append(float(m[k]["loss"]))
            if bool(m[k]["overflow"]):
                overflowed[k].append(it)
        for key, trainer, b in (("static_densify", st, before[0]),
                                ("dynamic_densify", dyn, before[1])):
            if key in m:
                densified[key] = (it, {k: int(v) for k, v in
                                       m[key]._asdict().items()},
                                  b, _alive(trainer))
    launches = dict(kernels.LAUNCHES)
    del st.step, joint.dyn_step     # the untimed methods again

    med = lambda xs: float(np.median(xs[-10:]) * 1e3)
    log(f"[joint] {last - first + 1} iterations {first}-{last}: "
        f"static_step_ms={med(step_s['static']):.3f} "
        f"dynamic_step_ms={med(step_s['dynamic']):.3f} "
        f"joint_iteration_ms={med(joint_s):.3f} (medians of the last 10, "
        f"synchronised)")
    log(f"[joint] launches on the joint path: {launches}")
    for key, (it, info, b, a) in densified.items():
        log(f"[joint] {key} at {it}: {info}, alive {b} -> {a}"
            + (f"; the dynamic store dropped {info['dropped']}"
               if key == "dynamic_densify" else ""))
    log(f"[joint] iterations that overflowed their fragment capacity: "
        f"{overflowed}")
    log(f"[joint] settled fragment profiles: static {st.fragment_profile!r} "
        f"(capacity {C.fragment_capacity(G.capacity_of(st.state.store), st.fragment_profile)}), "
        f"dynamic {joint.dyn_fragment_profile!r} (capacity "
        f"{C.fragment_capacity(G.capacity_of(st.state.store) + G.capacity_of(dyn.state.store), joint.dyn_fragment_profile)})")
    for k in losses:
        require(all(math.isfinite(x) for x in losses[k]),
                f"non-finite {k} loss {losses[k]}")
    terms = {k: float(v) for k, v in m["dynamic"].items()
             if k not in ("loss", "overflow", "dropped", "num_fragments")}
    log(f"[joint] last dynamic terms {terms}")
    f8, l8 = np.mean(losses["dynamic"][:8]), np.mean(losses["dynamic"][-8:])
    log(f"[joint] dynamic loss first-8 mean {f8:.6f} -> last-8 mean {l8:.6f}; "
        f"static {np.mean(losses['static'][:8]):.6f} -> "
        f"{np.mean(losses['static'][-8:]):.6f}")
    require(l8 < f8, "the dynamic loss did not fall")
    moved_c = float((dyn.state.motion_coeff - coeff0).abs().max())
    moved_n = max(float((dyn.state.net["timenet"][k] - v).abs().max())
                  for k, v in net0.items())
    log(f"[joint] motion_coeff moved max {moved_c:.3g}, timenet weights "
        f"moved max {moved_n:.3g}")
    require(moved_c > 0 and moved_n > 0, "the motion model did not move")
    require(set(densified) == {"static_densify", "dynamic_densify"}
            and all(v[0] == 600 for v in densified.values()),
            f"densification did not run for both models at 600: {densified}")
    s_info = densified["static_densify"][1]
    require(s_info["num_cloned"] + s_info["num_split"] > 0,
            "no clone or split in the static store")
    for key, (_, info, b, a) in densified.items():
        # a pruned or split gaussian leaves (some are both); each placed
        # clone or child arrives
        low = b - info["num_pruned"] - info["num_split"] + info["num_cloned"] \
            - info["dropped"]
        high = (b - max(info["num_pruned"], info["num_split"])
                + info["num_cloned"] + 2 * info["num_split"] - info["dropped"])
        require(low <= a <= high and info["dropped"] >= 0,
                f"{key}: alive {b} -> {a} does not fit {info}")
    require(not bool(m["static"]["overflow"]) and
            not bool(m["dynamic"]["overflow"]), "fragment overflow at the end")
    require(all(launches[k] > 0 for k in kernels.KERNELS),
            f"a kernel never launched on the joint path: {launches}")

    # the four kernels against their plain versions on the concatenated
    # static + deformed dynamic set of frame 0 (the dynamic step's input)
    errs, _ = check_concatenated(joint, batch_for(0), W, H, "joint", seed=4)

    # the profiler: 5 joint iterations, one with rigidity, then one
    # densification call of each model (its result discarded)
    from torch.profiler import ProfilerActivity, profile

    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(last + 1, last + 1 + steps):
            joint.train_iteration(batch_for(it - 1), batch_for(it - 1), it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_summary(prof, steps, wall_ms, "joint profile")
    for name in ("motion_mlp", "rigidity_knn"):
        ms, n = range_device_ms(prof, name)
        log(f"[joint profile] {name}: {ms:.4f} ms of device time in {n} "
            f"calls over {steps} iterations (forward only; the backward "
            f"runs outside the range)")
    for name, trainer in (("static", st), ("dynamic", dyn)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.densify(trainer.state, None)
            torch.cuda.synchronize()
        ms, _ = range_device_ms(prof, "densify_and_prune")
        log(f"[joint profile] densify_and_prune of the {name} model "
            f"({G.capacity_of(trainer.state.store)} slots): {ms:.4f} ms of "
            f"device time")
    log(f"[joint] phase {time.perf_counter() - t_phase:.2f} s")
    return launches, errs, dict(joint=joint, gt_render=gt_render,
                                gt_poses=gt_poses, size=(W, H),
                                iteration=last + steps)


# --------------------------------------------------------------------------
# the evaluator
# --------------------------------------------------------------------------

# configs/eval/eval_wo_align.yaml and eval_w_align.yaml, spelled out
EVAL_WO_ALIGN = dict(camera_lr=-1, num_opts=-1)
EVAL_W_ALIGN = dict(camera_lr=5e-5, num_opts=1000)
EVAL_VIEWS = (0, 2, 4, 6)       # test view i: halfway between train i, i+1
EVAL_ALIGNED_VIEWS = 2
LPIPS_SIZE = 512


class InMemoryData:
    """The evaluator's duck-typed datamodule (test frames with their poses,
    the calibrated train poses, the scene radius), held in memory."""

    def __init__(self, frames, q_c2w, t_c2w, train_poses, radius):
        self.frames, self.q_c2w, self.t_c2w = frames, q_c2w, t_c2w
        self.image_height, self.image_width = frames[0]["image"].shape[:2]
        self._train_poses, self._radius = train_poses, radius
        self.skip_dynamic = False

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]

    def get_test_dset(self):
        return self

    def get_test_sampler(self):
        return list(range(len(self.frames)))

    def get_train_poses(self):
        return self._train_poses

    def get_normalization(self):
        return {"radius": self._radius}


def c2w_matrices(q, t) -> np.ndarray:
    """[F, 4, 4] c2w from quaternions [F, 4] and translations [F, 3]."""
    import torch
    from rodygs_tpu_torch.ops.quaternion import quat_to_matrix

    out = np.tile(np.eye(4, dtype=np.float32), (len(q), 1, 1))
    out[:, :3, :3] = quat_to_matrix(torch.as_tensor(q).cpu()).numpy()
    out[:, :3, 3] = torch.as_tensor(t).cpu().numpy()
    return out


def make_test_views(gt_render, views, device, fov=0.9, n_frames=8, seed=17):
    """Test frames halfway between the train cameras on the +-0.2 rad arc,
    at times (2i+1)/14; GT is the joint phase's GT render + N(0, 0.05)."""
    from rodygs_tpu_torch.render.camera import make_camera

    rng = np.random.default_rng(seed)
    edges = np.linspace(-0.2, 0.2, n_frames)
    q, t, frames = [], [], []
    for i in views:
        ang = 0.5 * (edges[i] + edges[i + 1])
        time_i = (2 * i + 1) / (2 * (n_frames - 1))
        q.append([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
        t.append([np.sin(ang) * 4.0, 0, 0])
        cam = make_camera(q[-1], t[-1], fov, fov, time_i, device=device)
        img = gt_render(cam, time_i)[0]["rendered_image"].cpu().numpy()
        frames.append({"image": np.clip(img + rng.normal(0, 0.05, img.shape),
                                        0, 1).astype(np.float32),
                       "image_name": f"test{i}", "time": time_i,
                       "fovx": fov, "fovy": fov})
    return frames, np.asarray(q, np.float32), np.asarray(t, np.float32)


def eval_without_alignment(device, dirpath, ckpts, data, out):
    """RoDyGSEvaluator.eval(eval_batch_size=2) over the test views, timed
    and counted as a user calls it. After it, each view is rendered again
    at the settled profile: it must drop nothing and give the stored PNG.
    Returns the kernels' launches inside eval()."""
    import cv2
    import torch
    import yaml
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.evalsuite.evaluator import RoDyGSEvaluator
    from rodygs_tpu_torch.render.camera import make_camera
    from rodygs_tpu_torch.utils.store import to_u16

    ev = RoDyGSEvaluator(dirpath, data, data, out, *ckpts, device=device,
                         **EVAL_WO_ALIGN)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = ev.eval(eval_batch_size=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[eval] result {json.dumps(result)}")
    timing, b = result["timing"], result["timing"]["eval_batch_size"]
    steady = timing["render_s_per_view_steady"]
    first = (timing["render_s_total"] - steady * (len(data) - b)) / b
    log(f"[eval] eval() {secs:.3f} s for {len(data)} views; render ms per "
        f"view as result.yaml reports them (render, copy to the host): "
        f"first chunk {1e3 * first:.2f}, steady (the chunks after the "
        f"first) {1e3 * steady:.2f}; settled fragment profile "
        f"{ev.fragment_profile!r}; launches inside eval() {launches}")
    viz = result["viz"]
    require(all(math.isfinite(v) for v in viz.values()), f"metric {viz}")
    require(all(math.isfinite(v) for v in result["pose"].values()),
            f"pose metrics {result['pose']}")
    again = []
    for i, f in enumerate(data.frames):
        cam = make_camera(data.q_c2w[i], data.t_c2w[i], f["fovx"], f["fovy"],
                          f["time"], device=device)
        o = ev.render_view(cam)
        again.append(dict(dropped=int(o["dropped"]),
                          demand=int(o["num_fragments"]),
                          image=o["rendered_image"].cpu().numpy()))
    log("[eval] the views again at the settled profile: " + "; ".join(
        f"t={f['time']:.4f} demand={r['demand']} dropped={r['dropped']}"
        for f, r in zip(data.frames, again)))
    require(all(r["dropped"] == 0 for r in again),
            "a view drops fragments at the settled profile")
    for sub in ("gt", "pred"):
        for i, f in enumerate(data.frames):
            name = f"{str(i).zfill(5)}_{f['image_name']}.png"
            img = cv2.imread(str(out / sub / "viz" / name),
                             cv2.IMREAD_UNCHANGED)
            src = f["image"] if sub == "gt" else again[i]["image"]
            require(img is not None and np.array_equal(img[..., ::-1],
                                                       to_u16(src)),
                    f"{sub}/{name} does not decode to the image")
    text = (out / "result.yaml").read_text()
    require(yaml.safe_load(text) == result, "result.yaml is not the result")
    log(f"[eval] {2 * len(data)} PNG files decode to the images; "
        f"result.yaml ({len(text.splitlines())} lines) loads back to the "
        f"result")
    return launches


def eval_with_alignment(device, dirpath, ckpts, data, out, steps=50):
    """eval() with test-time pose optimisation at the config's values, timed
    and counted as a user calls it; each view's optimisation is timed at
    the boundary of PoseOptimizer.optimize (synchronised) and its start and
    end pose kept. After eval(): each view's photometric L2 at both poses,
    the median of `steps` synchronised pose steps, torch.profiler over 20
    steps, and the four kernels against their plain versions on a
    pose-step render. Returns (the kernels' launches inside eval(),
    {kernel: max_abs_err})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.evalsuite.evaluator import RoDyGSEvaluator
    from rodygs_tpu_torch.evalsuite.pose_opt import PoseOptimizer
    from rodygs_tpu_torch.render.binning import tile_grid
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.optim import adam_init

    ev = RoDyGSEvaluator(dirpath, data, data, out, *ckpts, device=device,
                         **EVAL_W_ALIGN)
    po = ev.pose_optimizer
    views, optimize = [], po.optimize

    def timed(q0, t0, camera, gt):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        q, t = optimize(q0, t0, camera, gt)
        torch.cuda.synchronize()
        views.append(dict(s=time.perf_counter() - t1, start=(q0, t0),
                          end=(q, t), camera=camera, gt=gt))
        return q, t

    po.optimize = timed
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    result = ev.eval(eval_batch_size=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    po.optimize = optimize
    n_opts = EVAL_W_ALIGN["num_opts"]
    log(f"[eval align] result {json.dumps(result)}")
    log(f"[eval align] eval() {secs:.2f} s for {len(data)} views x {n_opts} "
        f"pose steps; each view's optimisation: " + ", ".join(
            f"{v['s']:.3f} s ({1e3 * v['s'] / n_opts:.3f} ms a step)"
            for v in views) + f"; launches inside eval() {launches}")
    require(all(math.isfinite(v) for v in result["viz"].values()),
            f"metric {result['viz']}")

    def cost(v, q, t):
        pred = po.render_fn(v["camera"]._replace(q_c2w=q, t_c2w=t))
        return float(torch.mean((pred - v["gt"]) ** 2))

    with torch.no_grad():
        l2 = [(cost(v, *v["start"]), cost(v, *v["end"])) for v in views]
    for i, (b, a) in enumerate(l2):
        log(f"[eval align] view {i}: photometric L2 {b:.6f} -> {a:.6f}")
    require(len(l2) == len(data) and all(a < b for b, a in l2),
            f"the photometric L2 did not fall on every view: {l2}")

    v = views[0]
    pose, opt, step_ms = v["start"], adam_init(v["start"]), []
    for _ in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pose, opt, _ = po.step(pose, opt, v["camera"], v["gt"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    log(f"[eval align] {steps} synchronised pose steps of view 0: median "
        f"{np.median(step_ms):.3f} ms, p90 {np.percentile(step_ms, 90):.3f}, "
        f"min {min(step_ms):.3f}")
    prof_po = PoseOptimizer(po.calibrated_poses, po.uncalibrated_poses,
                            po.render_fn, po.camera_lr, 20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof_po.optimize(*v["start"], v["camera"], v["gt"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3 / 20
    device_summary(prof, 20, wall_ms, "eval profile", top=10)

    st = ev.static_store
    tx, ty = tile_grid(ev.image_width, ev.image_height)
    cam = v["camera"]._replace(q_c2w=v["end"][0], t_c2w=v["end"][1])
    s = KC.capture_stages(st.params, st.alive, cam, ev.active_sh_degree,
                          ev.image_width, ev.image_height, "lean",
                          _default_tight(tx * ty), 3)
    errs = KC.check_stages(s)
    log(f"[eval align] the static set at view 0's end pose (the pose "
        f"step's render, {int(s['cb'].num_fragments)} fragments): "
        f"max_abs_err={errs}")
    return launches, errs


def check_lpips_on_card(device, path):
    """Both nets on one LPIPS_SIZE^2 pair, on the card and on the CPU."""
    import torch
    from rodygs_tpu_torch.evalsuite.lpips import lpips_fn

    rng = np.random.default_rng(5)
    a = rng.uniform(size=(LPIPS_SIZE, LPIPS_SIZE, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    for net in ("alex", "vgg"):
        card, cpu = lpips_fn(net, path, device), lpips_fn(net, path, "cpu")
        ta, tb = torch.tensor(a, device=device), torch.tensor(b, device=device)
        v_card = float(card(ta, tb))
        ms = time_ms(lambda: card(ta, tb), reps=5)
        t0 = time.perf_counter()
        v_cpu = float(cpu(a, b))
        cpu_s = time.perf_counter() - t0
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        log(f"[eval lpips] {net} {LPIPS_SIZE}x{LPIPS_SIZE}: card {v_card:.8f} "
            f"({ms:.3f} ms a pair), cpu {v_cpu:.8f} ({cpu_s:.2f} s), "
            f"relative difference {rel:.3g} (tol 1e-4)")
        require(rel <= 1e-4, f"LPIPS {net} differs between card and CPU")


def render_sort_bands(device, n=240_000, width=1920, height=1080):
    """The 1080p phase's state rendered in rows mode at profile "huge" with
    1, 2 and 4 sort bands: the images must keep their bits, the gradients
    of means3d, opacity and the pose agree within 5e-4 of their maximum;
    expand and segsum launch once a band. Returns (params, camera, demand)
    for `check_band_kernels` and the kernels' launches in the renders."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.rasterize import render

    params, cam = KC.random_scene(n, 5, device, log_scale=(-5.6, -4.2))
    target = torch.rand((height, width, 3), device=device,
                        generator=torch.Generator(device=device).manual_seed(9))
    outs = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for bands in (1, 2, 4):
        leaves = [params.xyz.clone().requires_grad_(True),
                  params.opacity.clone().requires_grad_(True)]
        q = cam.q_c2w.clone().requires_grad_(True)
        t = cam.t_c2w.clone().requires_grad_(True)
        p = params._replace(xyz=leaves[0], opacity=leaves[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = render(p.xyz, G.get_features(p), G.get_opacity(p),
                   G.get_scaling(p), p.rotation,
                   cam._replace(q_c2w=q, t_c2w=t), 3, width, height,
                   fragment_profile="huge", tight_rect="rows",
                   include_normal=False, sort_bands=bands)
        torch.mean((o["rendered_image"] - target) ** 2).backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        outs[bands] = dict(image=o["rendered_image"].detach(),
                           grads=[leaves[0].grad, leaves[1].grad, q.grad,
                                  t.grad], demand=int(o["num_fragments"]),
                           dropped=int(o["dropped"]))
        log(f"[eval bands] {width}x{height} n={n} rows, 'huge', bands="
            f"{bands}: forward+backward {ms:.1f} ms (first call), demand "
            f"{outs[bands]['demand']} dropped {outs[bands]['dropped']}")
    launches = dict(kernels.LAUNCHES)
    log(f"[eval bands] launches in the three renders: {launches}")
    require(launches == dict(expand=1 + 2 + 4, tile_fwd=3, tile_bwd=3,
                             segsum=1 + 2 + 4),
            "expand and segsum do not launch once a band")
    ref = outs[1]
    for bands in (2, 4):
        require(torch.equal(outs[bands]["image"], ref["image"]),
                f"the image of {bands} bands differs from one band's")
        errs = []
        for name, a, b in zip(("means3d", "opacity", "q", "t"),
                              ref["grads"], outs[bands]["grads"]):
            e = float((a - b).abs().max()) / (float(a.abs().max()) + 1e-30)
            require(e <= 5e-4, f"{bands} bands: {name} gradient {e:.3g}")
            errs.append(f"{name} {e:.3g}")
        log(f"[eval bands] bands={bands}: image bit-identical to 1 band; "
            f"gradient / max: {', '.join(errs)}")
    return (params, cam, ref["demand"]), launches


def check_band_kernels(params, cam, demand, width=1920, height=1080):
    """The four kernels on the 1080p state's binning at 2 and 4 bands
    against their plain versions: expand and segsum on every band, the tile
    kernels on the bands' concatenated records. Returns {kernel:
    max_abs_err}."""
    import torch

    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.evalsuite.evaluator import eval_fit_profile

    n = params.xyz.shape[0]
    kerrs = {}
    for bands in (2, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e, cb = KC.check_bands(params, None, cam, 3, width, height, "huge",
                               "rows", bands)
        log(f"[eval bands] {bands} bands (f_kept {cb.f_kept.tolist()} of "
            f"{cb.bases.shape[1] * 512} slots a band, tile counts max "
            f"{int(cb.tile_counts.max())}): expand and segsum on each band, "
            f"the tile kernels on the concatenated records: max_abs_err={e}; "
            f"segsum and tile_bwd twice: equal bits "
            f"({time.perf_counter() - t0:.2f} s)")
        del cb
        torch.cuda.empty_cache()
        for k, v in e.items():
            kerrs[k] = max(kerrs.get(k, 0.0), v)
    log(f"[eval bands] eval_fit_profile for this state ({n} gaussians, "
        f"demand {demand}, from 'huge'): "
        f"{eval_fit_profile(n, demand, 'huge')!r}")
    return kerrs


def phase_eval(device, state):
    """The evaluator on the joint phase's end state (8): checkpoints through
    RoDyGSTrainer.save_checkpoints, 4 test views without alignment, 2 with
    it at the config's 1000 steps, LPIPS on the card against the CPU, the
    1080p state at 1, 2 and 4 sort bands. Returns ({kernel: launches
    inside the two eval() calls}, {kernel: launches in the banded
    renders}, {kernel: max_abs_err})."""
    import shutil
    import tempfile
    import torch
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.evalsuite.lpips import write_random_weights

    t_phase = time.perf_counter()
    joint = state["joint"]
    root = Path(tempfile.mkdtemp(prefix="rodygs_eval_"))
    try:
        joint.logdir = root / "ckpt"
        t0 = time.perf_counter()
        joint.save_checkpoints(state["iteration"])
        ckpts = (root / "ckpt" / "static_last.ckpt",
                 root / "ckpt" / "dynamic_last.ckpt")
        log(f"[eval] checkpoints of iteration {state['iteration']} written "
            f"in {time.perf_counter() - t0:.2f} s: " + ", ".join(
                f"{p.name} {p.stat().st_size / 2**20:.1f} MiB" for p in ckpts))
        frames, q, t = make_test_views(state["gt_render"], EVAL_VIEWS, device)
        gq, gt = state["gt_poses"]
        with open(root / "train_transforms.json", "w") as f:
            json.dump({"camera_angle_x": float(np.rad2deg(0.9)),
                       "frames": [{"transform_matrix": m.tolist()}
                                  for m in c2w_matrices(gq, gt)]}, f)
        st = joint.static.state
        calibrated = c2w_matrices(st.poses.q_c2w, st.poses.t_c2w)
        data = InMemoryData(frames, q, t, calibrated, 4.0)
        wo = eval_without_alignment(device, str(root), ckpts, data,
                                    root / "wo")
        k = EVAL_ALIGNED_VIEWS
        aligned = InMemoryData(frames[:k], q[:k], t[:k], calibrated, 4.0)
        w, errs = eval_with_alignment(device, str(root), ckpts, aligned,
                                      root / "w")
        write_random_weights(root / "lpips.npz")
        check_lpips_on_card(device, str(root / "lpips.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: wo[k] + w[k] for k in kernels.KERNELS}
    log(f"[eval] launches inside the two eval() calls: {launches}")
    require(all(launches[k] > 0 for k in kernels.KERNELS),
            f"a kernel never launched inside eval(): {launches}")
    torch.cuda.empty_cache()
    banded, launches_bands = render_sort_bands(device)
    for name, e in check_band_kernels(*banded).items():
        errs[name] = max(errs.get(name, 0.0), e)
    log(f"[eval] max_abs_err in the phase {errs}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return launches, launches_bands, errs


# --------------------------------------------------------------------------
# phase 8: the CLIs on a scene on disk
# --------------------------------------------------------------------------

CLI_TRAIN_YAML = "configs/train/train_kubric_mrig.yaml"
CLI_EVAL_YAMLS = ("configs/eval/eval_wo_align.yaml",
                  "configs/eval/eval_w_align.yaml")
CLI_SIZE, CLI_FRAMES = 512, 24          # kubric frames: 24 at times i/23
CLI_STATIC, CLI_DYNAMIC = 5_000, 1_000  # points per frame's ply
CLI_TEST_AFTER = (2, 8, 14, 20)         # test view halfway after train i
CLI_ITERATIONS, CLI_CHECKPOINT_EVERY = 700, 350
CLI_ALIGN_STEPS = 100                   # eval_w_align's 1000, cut by dotlist
CLI_MULTIRES = 26                       # the shipped time embedding


def _cli(args, tag, timeout):
    """Run `python -m <args>` from the repository root; returns (stdout,
    wall seconds). Raises CheckFailed on a non-zero exit."""
    cmd = [sys.executable, "-m", *map(str, args)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        log(res.stdout[-4000:] + res.stderr[-4000:])
    require(res.returncode == 0, f"{tag}: exit code {res.returncode}")
    return res.stdout, secs


def _json_after(text, prefix):
    lines = [ln for ln in text.splitlines() if prefix in ln]
    require(bool(lines), f"no line with {prefix!r}")
    return json.loads(lines[-1].split(prefix, 1)[1])


def time_embedding_columns(device, frames=CLI_FRAMES, multires=CLI_MULTIRES):
    """The port's time embedding at the shipped 26 linear frequencies for
    the scene's frame times, on the card and on the CPU, against two
    float64 embeddings: of the same float32 arguments t*(f*pi) with the
    JAX package's frequency table (the sin/cos implementation's error) and
    of the exact arguments (the
    float32 rounding of t*f*pi as well). Returns {comparison: [(column,
    max |difference|)]} for the columns past 1e-6."""
    import torch
    from rodygs_tpu_torch.models.motion import embed_time, xla_linspace

    t = torch.arange(frames, dtype=torch.float32) / (frames - 1)
    names = ["t"] + [f"{fn}(f{k})" for k in range(multires)
                     for fn in ("sin", "cos")]
    freqs = torch.from_numpy(xla_linspace(1.0, 2.0 ** (multires - 1),
                                          multires))
    arg32 = (t[:, None] * (freqs * math.pi)).double()
    arg64 = (t.double()[:, None] * torch.linspace(
        1.0, 2.0 ** (multires - 1), multires, dtype=torch.float64) * math.pi)

    def f64(arg):
        sc = torch.stack([torch.sin(arg), torch.cos(arg)], -1).reshape(
            frames, 2 * multires)
        return torch.cat([t.double()[:, None], sc], 1)

    out = {}
    for where, emb in (("card", embed_time(t.to(device), multires, False)),
                       ("cpu", embed_time(t, multires, False))):
        emb = emb.double().cpu()
        for ref_name, ref in (("float32 argument", f64(arg32)),
                              ("exact argument", f64(arg64))):
            diff = (emb - ref).abs().max(0).values
            out[f"{where} vs float64 of the {ref_name}"] = [
                (names[c], float(diff[c])) for c in range(diff.numel())
                if diff[c] > 1e-6]
    return out


def write_cli_scene(root, device, tag):
    """The kubric-shaped scene of the CLI phases under root/scene; returns
    its path."""
    import shutil
    from rodygs_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    test_times = [(i + 0.5) / (CLI_FRAMES - 1) for i in CLI_TEST_AFTER]
    scene = synthetic.make_scene_views(
        CLI_STATIC, CLI_DYNAMIC, CLI_FRAMES, CLI_SIZE, CLI_SIZE,
        test_times=test_times, device=device)
    data = synthetic.write_scene(root / "scene", scene, CLI_SIZE, CLI_SIZE,
                                 pose_noise_rot_deg=0.3, pose_noise_trans=0.01)
    del scene
    # the train config's MASt3R experiment; the eval configs' test readers
    # read exp0's global_params.pkl
    shutil.copytree(data / "mast3r_opt" / "exp0",
                    data / "mast3r_opt" / "swin_noloop_000")
    log(f"[{tag}] scene written in {time.perf_counter() - t0:.2f} s: "
        f"{CLI_SIZE}x{CLI_SIZE}, {CLI_FRAMES} train frames, test times "
        f"{[round(x, 4) for x in test_times]}, plys of {CLI_STATIC} "
        f"static and {CLI_DYNAMIC} dynamic points a frame")
    return data


def phase_cli(device):
    """The train CLI and both eval CLIs, as subprocesses, on a scene that
    `data/synthetic.py` writes at the kubric shape (phase 8); the kernels
    against their plain versions on the train run's end state. Returns
    ({cli: {kernel: launches}}, {kernel: max_abs_err}, the train CLI's
    StepTimer p50 in ms)."""
    import shutil
    import tempfile
    import torch
    import yaml
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.pipelines.build import (build_training_run,
                                                  make_frame_batch)
    from rodygs_tpu_torch.utils import native
    from rodygs_tpu_torch.utils.checkpoint import load_checkpoint
    from rodygs_tpu_torch.utils.config import load_yaml

    t_phase = time.perf_counter()
    host_ops = native.backend()
    log(f"[cli] host ops: {host_ops}")
    require(host_ops == "native", "the native host-ops library did not build")
    for col in time_embedding_columns(device).items():
        log(f"[cli] time embedding at {CLI_MULTIRES} frequencies, "
            f"{CLI_FRAMES} frame times, columns past 1e-6, {col[0]}: "
            + (", ".join(f"{n} {d:.3g}" for n, d in col[1]) or "none"))

    root = Path(tempfile.mkdtemp(prefix="rodygs_cli_"))
    launches = {}
    try:
        data = write_cli_scene(root, device, "cli")

        out, secs = _cli(
            ["rodygs_tpu_torch.pipelines.train", "-d", data, "-b",
             CLI_TRAIN_YAML, "-g", "cli", "-n", "kubric", "-l", root / "logs",
             "--num_iterations", CLI_ITERATIONS, "--checkpoint_every",
             CLI_CHECKPOINT_EVERY], "train CLI", timeout=400)
        run = root / "logs" / "cli" / "kubric_777"
        train_log = (run / "train" / "train.log").read_text()
        load_s = float(train_log.split("data loaded in ")[1].split()[0])
        losses = [(int(ln.split("[")[1].split("/")[0]),
                   float(ln.split(" static ")[1].split()[0]))
                  for ln in train_log.splitlines() if " static " in ln]
        steps = _json_after(train_log, "step times ")
        launches["train"] = _json_after(train_log, "kernel launches ")
        log(f"[cli] train CLI {secs:.2f} s wall; data load {load_s:.3f} s "
            f"(train.log); StepTimer over {steps['steps']} iterations: p50 "
            f"{steps['p50_ms']:.3f} ms, p90 {steps['p90_ms']:.3f}, mean "
            f"{steps['mean_ms']:.3f}; static loss "
            + ", ".join(f"{i}: {v:.4f}" for i, v in losses[::2])
            + f"; launches {launches['train']}")
        require(all(math.isfinite(v) for _, v in losses)
                and losses[-1][0] == CLI_ITERATIONS
                and np.mean([v for _, v in losses[-3:]]) < losses[0][1],
                f"the static loss did not fall: {losses}")
        require(all(launches["train"][k] >= 2 * CLI_ITERATIONS
                    for k in launches["train"]),
                f"a kernel launched less than twice an iteration: "
                f"{launches['train']}")
        for name in ("static_last.ckpt", "dynamic_last.ckpt", "resume.ckpt"):
            require((run / "train" / name).exists(), f"no {name}")

        # the snapshot reads back as the end state
        config = load_yaml(str(run / "train" / "config.yaml"))
        back = build_training_run(config, dirpath=str(data),
                                  capacity_factor=4.0, device=device)
        nxt = back.joint.load_resume(run / "train" / "resume.ckpt")
        ends = [load_checkpoint(run / "train" / f"{s}_last.ckpt")[0]
                for s in ("static", "dynamic")]
        require(nxt == CLI_ITERATIONS + 1, f"resume at {nxt}")
        same = []
        for trainer, end in zip((back.joint.static, back.joint.dynamic), ends):
            got = G.to_state_dict(trainer.state.store)
            for k, v in got.items():
                same.append(np.array_equal(v.cpu().numpy(), end["model"][k]))
        dyn = back.joint.dynamic.state
        same.append(np.array_equal(dyn.motion_coeff.cpu().numpy(),
                                   ends[1]["model"]["_motion_coeff"]))
        same.append(np.array_equal(back.joint.static.state.poses.q_c2w.cpu()
                                   .numpy(), ends[0]["camera"]["q_c2w"]))
        require(all(same), "resume.ckpt does not hold the end state")
        alive = [int(G.num_alive(t.state.store))
                 for t in (back.joint.static, back.joint.dynamic)]
        log(f"[cli] resume.ckpt reads back as iteration {nxt} with the end "
            f"state ({len(same)} arrays equal; alive static {alive[0]}, "
            f"dynamic {alive[1]})")
        frame = back.dynamic_dm.get_train_dset()[0]
        errs, _ = check_concatenated(
            back.joint, make_frame_batch(frame, 0, device), CLI_SIZE,
            CLI_SIZE, "cli", seed=6)
        del back
        torch.cuda.empty_cache()

        for cfg in CLI_EVAL_YAMLS:
            task = Path(cfg).stem
            extra = ([f"eval.params.num_opts={CLI_ALIGN_STEPS}"]
                     if "w_align" in task else [])
            out, secs = _cli(
                ["rodygs_tpu_torch.pipelines.eval", "-c", cfg, "-d", data,
                 "-m", run, "-t", task, "--eval_batch_size", 2, *extra],
                f"eval CLI {task}", timeout=300)
            result = yaml.safe_load((run / task / "result.yaml").read_text())
            launches[task] = _json_after(out, "kernel launches ")
            fields = {**result["viz"], **result["pose"]}
            log(f"[cli] eval CLI {task} {secs:.2f} s wall; result "
                f"{json.dumps(fields)}; timing {json.dumps(result['timing'])}"
                f"; launches inside eval() {launches[task]}")
            for key in ("psnr", "ssim", "msssim", "ATE", "RPE_trans",
                        "RPE_rot"):
                require(key in fields and math.isfinite(fields[key]),
                        f"{task}: {key} missing or not finite")
            video = run / task / "video.mp4"
            require(video.exists() and video.stat().st_size > 0,
                    f"{task}: no video.mp4")
            n_png = len(list((run / task / "pred" / "viz").glob("*.png")))
            require(n_png == len(CLI_TEST_AFTER), f"{task}: {n_png} PNGs")
            if extra:
                pose = _json_after(out, "pose steps ")
                log(f"[cli] {task} pose steps {pose}")
                require(pose["steps"] == CLI_ALIGN_STEPS * len(CLI_TEST_AFTER)
                        and pose["dropped"] == 0,
                        f"a pose step dropped fragments: {pose}")
                need = ("expand", "tile_fwd", "tile_bwd", "segsum")
            else:
                need = ("expand", "tile_fwd")
            require(all(launches[task][k] > 0 for k in need),
                    f"{task}: a kernel never launched {launches[task]}")
            log(f"[cli] {task}: video.mp4 {video.stat().st_size} bytes, "
                f"{n_png} PNGs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[cli] phase {time.perf_counter() - t_phase:.2f} s")
    return launches, errs, steps["p50_ms"]


# --------------------------------------------------------------------------
# phase 9: multi-device training, on one card
# --------------------------------------------------------------------------

MULTI_SPLITS = (2, 3, 8)
MULTI_MESHES = ({"data": 2, "gauss": 1, "tile": 2},
                {"data": 1, "gauss": 2, "tile": 2})
MULTI_STEPS = 20
MULTI_JOINT_ITERATIONS = (598, 600)     # both models densify at 600
MULTI_CLI = (100, 50, 150)              # iterations, snapshot, resume to
MULTI_TIMEOUT = 600.0
MULTI_REDUCED = ("four ranks share one H100 over Gloo: correctness of the "
                 "sharded path, not a multi-GPU speed",)


def _mesh_tag(shape):
    return "x".join(str(shape[a]) for a in ("data", "gauss", "tile"))


def _scaled_err(ref, got):
    return float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)


def multi_rank(rank, meshes, steps, joint_its, device="cuda", bench_kw=None,
               joint_kw=None):
    """One rank of the 4-rank world (phase 9c), on the card unless `device`
    is "cpu" (with `bench_kw` / `joint_kw` cutting the scenes: a rehearsal
    on the CPU). For each mesh: the bench
    trainer on the mesh, the first sharded step's gradients (rank 0 holds
    them against one process's mean-frame gradients on the same global
    store), `steps` sharded steps, one sharded densification; on the last
    mesh the sharded joint iteration at the kubric size, and rank 0 holds
    the four kernels against their plain versions on its render's share.
    Every rank counts its own kernel launches."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.parallel import collectives as PC
    from rodygs_tpu_torch.parallel.mesh import make_mesh
    from rodygs_tpu_torch.parallel.sharded import composite_axes, stack_batches
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    out = {"rank": rank, "meshes": {}}
    launches = {k: 0 for k in kernels.KERNELS}
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    bench_kw, joint_kw = bench_kw or {}, joint_kw or {}

    def count(fn):
        kernels.reset_launches()
        r = fn()
        sync()
        for k, v in kernels.LAUNCHES.items():
            launches[k] += v
        return r

    for shape in meshes:
        tag = _mesh_tag(shape)
        mesh = make_mesh(n_data=shape["data"], n_tile=shape["tile"],
                         n_gauss=shape["gauss"],
                         device=None if on_card else "cpu")
        trainer, batch_for, (width, height) = bench_trainer(
            mesh.device, mesh=mesh, **bench_kw)
        n_data = shape["data"]

        def batch(it):
            return stack_batches([batch_for((it - 1) * n_data + j)
                                  for j in range(n_data)])

        active = trainer.loss.active_set(1)
        sh, prof = trainer.active_sh_degree, trainer.fragment_profile
        grads = count(lambda: trainer._sharded_step.grads(
            trainer.state, batch(1), active, sh, prof))
        gauss = mesh.axis("gauss")
        g_params = PC.all_gather_rows(grads[1], gauss)
        res = {"coords": mesh.coords, "loss0": float(grads[0])}
        # Gloo's CUDA all-reduce of the parameter gradients over the data
        # axis, as the step runs it (ranks sharing one card)
        data = mesh.axis("data")
        if data.size > 1:
            times = []
            for _ in range(5):
                sync()
                t0 = time.perf_counter()
                PC.psum(grads[1], data)
                sync()
                times.append((time.perf_counter() - t0) * 1e3)
            res["psum_ms"] = float(np.median(times))
            res["psum_mb"] = sum(g.numel() for g in grads[1]) * 4 / 2**20
        ref = None
        if rank == 0:
            ref, _, _ = bench_trainer(mesh.device, **bench_kw)
            ref.state = ref.state._replace(store=G.shard_interleave(
                ref.state.store, shape["gauss"]))
            parts = [ref.loss_and_grads(ref.state, batch_for(j), active, sh,
                                        prof) for j in range(n_data)]
            loss_ref = float(np.mean([float(p[0]) for p in parts]))
            res["loss_rel_err"] = abs(res["loss0"] - loss_ref) / loss_ref
            res["grad_err"] = {}
            for name, i in (("params", 0), ("poses", 1)):
                got = g_params if i == 0 else grads[2]
                for f, g in zip(got._fields, got):
                    mean = sum(p[2][i]._asdict()[f] for p in parts) / n_data
                    res["grad_err"][f"{name}.{f}"] = _scaled_err(mean, g)
        losses, step_ms = [], []
        for it in range(1, steps + 1):
            sync()
            t0 = time.perf_counter()
            m = count(lambda: trainer.train_iteration(batch(it), it))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        _, info = count(lambda: trainer.densify(trainer.state, None))
        res.update(losses=losses, step_ms=step_ms,
                   densify={k: int(v) for k, v in info._asdict().items()},
                   alive=int(PC.psum(G.num_alive(trainer.state.store)
                                     .reshape(1), gauss)),
                   profile=str(trainer.fragment_profile))
        if rank == 0 and shape is meshes[-1]:
            comp = composite_axes(mesh)
            cam = make_camera_from_poses(ref.state.poses, batch_for(0))
            s = KC.capture_stages(ref.state.store.params, ref.state.store.alive,
                                  cam, sh, width, height, prof,
                                  _default_tight(32 * 32), 4)
            res["kernel_errs"] = KC.check_tile_block(s, comp.size, comp.index)
        del trainer, ref
        if on_card:
            torch.cuda.empty_cache()
        out["meshes"][tag] = res

    mesh = make_mesh(n_data=meshes[-1]["data"], n_tile=meshes[-1]["tile"],
                     n_gauss=meshes[-1]["gauss"],
                     device=None if on_card else "cpu")
    joint, frame_for, _, _ = joint_trainer(mesh.device, mesh=mesh, **joint_kw)
    st = joint.static
    xyz0 = st.state.store.params.xyz.clone()
    coeff0 = joint.dynamic.state.motion_coeff.clone()
    n_data = mesh.shape["data"]
    jres = {"losses": [], "densify": {}}
    for it in range(joint_its[0], joint_its[1] + 1):
        b = stack_batches([frame_for(it * n_data + j) for j in range(n_data)])
        m = count(lambda: joint.train_iteration(b, b, it))
        jres["losses"].append((float(m["static"]["loss"]),
                               float(m["dynamic"]["loss"])))
        for k in ("static_densify", "dynamic_densify"):
            if k in m:
                jres["densify"][k] = {f: int(v)
                                      for f, v in m[k]._asdict().items()}
    jres["moved"] = [float((st.state.store.params.xyz - xyz0).abs().max()),
                     float((joint.dynamic.state.motion_coeff - coeff0)
                           .abs().max())]
    out["joint"] = jres
    out["launches"] = launches
    return out


def multi_nccl_single(device, trainer, batch_for):
    """(9b) The sharded static step at world size 1 over NCCL, against the
    trainer's own step, from the trained state."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from rodygs_tpu_torch.parallel.mesh import make_mesh
    from rodygs_tpu_torch.parallel.sharded import (make_sharded_static_step,
                                                   stack_batches)

    tmp = tempfile.mkdtemp(prefix="rodygs_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device=device)
        step = make_sharded_static_step(trainer.cfg, trainer.loss, mesh,
                                        trainer.spatial_lr_scale, trainer.gen)
        it = 1000
        active = trainer.loss.active_set(it)
        args = (float(it), active, trainer.active_sh_degree,
                trainer.fragment_profile)
        single, m1 = trainer.step(trainer.state, batch_for(0), *args)
        sharded, m2 = step(trainer.state, stack_batches([batch_for(0)]),
                           *args)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    exact = all(torch.equal(a, b) for a, b in zip(
        [*single.store.params, *single.poses, *single.opt.mu, *single.opt.nu],
        [*sharded.store.params, *sharded.poses, *sharded.opt.mu,
         *sharded.opt.nu]))
    stats = max(_scaled_err(a, b) for a, b in zip(single.stats, sharded.stats))
    log(f"[multi] (b) one NCCL rank ({mesh.backend}, mesh {mesh.shape}): the "
        f"sharded step against the trainer's, params / poses / moments "
        f"bit-identical {exact}, statistics scaled error {stats:.3g}, loss "
        f"{float(m1['loss']):.6f} / {float(m2['loss']):.6f}")
    require(exact and stats <= 1e-6
            and float(m1["loss"]) == float(m2["loss"]),
            "the sharded step at world size 1 differs from the trainer's")


def multi_torchrun_cli(device):
    """(9d) The train CLI under torchrun, 2 processes over Gloo on the one
    card, `--mesh data=2`: MULTI_CLI[0] iterations with a snapshot every
    MULTI_CLI[1], then `--resume` to MULTI_CLI[2]; one writer's files, a log
    per rank, and the single-process port loads the resume file. Returns
    each rank's kernel launches of the first run."""
    import os
    import shutil
    import tempfile
    import torch
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.pipelines.build import build_training_run
    from rodygs_tpu_torch.utils.checkpoint import load_checkpoint
    from rodygs_tpu_torch.utils.config import load_yaml

    iters, every, resume_to = MULTI_CLI
    root = Path(tempfile.mkdtemp(prefix="rodygs_multi_"))
    env = dict(os.environ, RODYGS_DIST_BACKEND="gloo", OMP_NUM_THREADS="1")
    try:
        data = write_cli_scene(root, device, "multi")
        run = root / "logs" / "multi" / "kubric_777" / "train"
        walls = []
        for n, extra in ((iters, []), (resume_to, ["--resume"])):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", "2", "-m",
                   "rodygs_tpu_torch.pipelines.train", "-d", str(data), "-b",
                   CLI_TRAIN_YAML, "-g", "multi", "-n", "kubric", "-l",
                   str(root / "logs"), "--num_iterations", str(n),
                   "--checkpoint_every", str(every), "--mesh", "data=2",
                   *extra, *(["--device", "cpu"] if device.type == "cpu"
                             else [])]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                                 capture_output=True, text=True, timeout=400,
                                 env=env)
            walls.append(time.perf_counter() - t0)
            if res.returncode != 0:
                log(res.stdout[-4000:] + res.stderr[-4000:])
            require(res.returncode == 0,
                    f"torchrun train CLI: exit code {res.returncode}")
        logs = [(run / f).read_text() for f in ("train.log", "train.p1.log")]
        files = sorted(p.name for p in run.iterdir() if p.is_file())
        log(f"[multi] (d) torchrun, 2 ranks, --mesh data=2: {iters} "
            f"iterations in {walls[0]:.2f} s wall, --resume to {resume_to} "
            f"in {walls[1]:.2f} s; files {files}")
        require({"train.log", "train.p1.log", "args.yaml", "config.yaml",
                 "static_last.ckpt", "dynamic_last.ckpt",
                 "resume.ckpt"} <= set(files), f"missing run files: {files}")
        launches = []
        for i, text in enumerate(logs):
            require(f"at iteration {iters + 1}" in text
                    and "'data': %d" % i in text,
                    f"rank {i}'s log lacks its mesh row or the resume")
            launches.append(json.loads(text.split("kernel launches ")[1]
                                       .splitlines()[0]))
            steps = [json.loads(ln.split("step times ", 1)[1])
                     for ln in text.splitlines() if "step times " in ln]
            log(f"[multi] (d) rank {i}: StepTimer p50 "
                f"{[round(x['p50_ms'], 3) for x in steps]} ms (two ranks "
                f"sharing one card); launches of the first run {launches[-1]}")
        require(all(v > 0 for v in launches[0].values()),
                f"a kernel never launched under torchrun: {launches[0]}")
        back = build_training_run(load_yaml(str(run / "config.yaml")),
                                  dirpath=str(data), capacity_factor=4.0,
                                  device=device)
        nxt = back.joint.load_resume(run / "resume.ckpt")
        end = load_checkpoint(run / "static_last.ckpt")[0]
        same = all(np.array_equal(v.cpu().numpy(), end["model"][k])
                   for k, v in G.to_state_dict(
                       back.joint.static.state.store).items())
        log(f"[multi] (d) the single-process port loads resume.ckpt at "
            f"iteration {nxt}; the static store equals static_last.ckpt: "
            f"{same}")
        require(nxt == resume_to + 1 and same,
                "the single-process port did not load the mesh's resume file")
        del back
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_multi(device, trainer, batch_for, bench_kw=None, joint_kw=None):
    """Phase 9: (a) the trained bench state's compact render split into 2,
    3 and 8 tile blocks in this process; (b) the sharded step over one NCCL
    rank; (c) a world of 4 Gloo ranks on the card (meshes 2x1x2 and 1x2x2,
    MULTI_STEPS steps each and a densification, then the joint iteration);
    (d) the train CLI under torchrun. Returns (per-rank launches in (c),
    {kernel: max_abs_err})."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.parallel.dryrun import run_world
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    t_phase = time.perf_counter()
    st = trainer.state
    cam = make_camera_from_poses(st.poses, batch_for(0))
    s = KC.capture_stages(st.store.params, st.store.alive, cam,
                          trainer.active_sh_degree, 512, 512,
                          trainer.fragment_profile, _default_tight(32 * 32), 5)
    splits = KC.check_tile_splits(s, MULTI_SPLITS)
    del s
    log(f"[multi] (a) the trained state's render in {list(MULTI_SPLITS)} "
        f"tile blocks at their offsets: planes bit-identical to the whole "
        f"grid's; summed table gradients, scaled error {splits}")
    multi_nccl_single(device, trainer, batch_for)

    t0 = time.perf_counter()
    ranks = run_world(multi_rank, 4, (MULTI_MESHES, MULTI_STEPS,
                                      MULTI_JOINT_ITERATIONS, device.type,
                                      bench_kw, joint_kw),
                      backend="gloo", timeout_s=MULTI_TIMEOUT)
    log(f"[multi] (c) 4 Gloo ranks on one card: {time.perf_counter() - t0:.2f}"
        f" s wall, every rank sharing the one H100 ({MULTI_REDUCED[0]})")
    errs = {}
    for shape in MULTI_MESHES:
        tag = _mesh_tag(shape)
        r0 = ranks[0]["meshes"][tag]
        log(f"[multi] (c) mesh {tag}: first step loss {r0['loss0']:.6f} "
            f"(relative error against one process's mean-frame loss "
            f"{r0['loss_rel_err']:.3g}); gradient scaled errors "
            f"{json.dumps({k: round(v, 8) for k, v in r0['grad_err'].items()})}")
        require(r0["loss_rel_err"] <= 1e-5, f"{tag}: loss off")
        require(max(r0["grad_err"].values()) <= 5e-4, f"{tag}: gradients off")
        for r in ranks:
            m = r["meshes"][tag]
            log(f"[multi] (c) mesh {tag} rank {r['rank']} {m['coords']}: "
                f"losses {m['losses'][0]:.5f} -> {m['losses'][-1]:.5f}, "
                f"per-rank step ms (4 ranks sharing one card) median "
                f"{np.median(m['step_ms'][-10:]):.2f}, densify "
                f"{m['densify']}, alive {m['alive']}, profile {m['profile']}"
                + (f", Gloo psum of {m['psum_mb']:.1f} MB gradients over the "
                   f"data axis {m['psum_ms']:.2f} ms" if "psum_ms" in m
                   else ""))
            require(all(math.isfinite(x) for x in m["losses"])
                    and np.mean(m["losses"][-8:]) < np.mean(m["losses"][:8]),
                    f"{tag} rank {r['rank']}: the loss did not fall")
            require(m["losses"] == r0["losses"],
                    f"{tag}: ranks disagree on the loss")
        if "kernel_errs" in r0:
            errs = r0["kernel_errs"]
            log(f"[multi] (c) mesh {tag}: the four kernels against their plain "
                f"versions on rank 0's share of the render: {errs}")
    for r in ranks:
        j = r["joint"]
        log(f"[multi] (c) joint iterations {MULTI_JOINT_ITERATIONS} rank "
            f"{r['rank']}: losses {j['losses']}, moved {j['moved']}, "
            f"densify {j['densify']}; launches {r['launches']}")
        require(all(math.isfinite(x) for pair in j["losses"] for x in pair)
                and min(j["moved"]) > 0, "the sharded joint iteration stalled")
        require(sorted(j["densify"]) == ["dynamic_densify", "static_densify"],
                "the sharded joint iteration did not densify")
        require(all(v > 0 for v in r["launches"].values()),
                f"rank {r['rank']} never launched a kernel: {r['launches']}")
    require(bool(errs), "no rank held the kernels against their plain versions")
    launches = [r["launches"] for r in ranks]
    cli_launches = multi_torchrun_cli(device)
    log(f"[multi] phase {time.perf_counter() - t_phase:.2f} s")
    return launches, cli_launches, errs


# --------------------------------------------------------------------------
# the flagship run
# --------------------------------------------------------------------------

# rodygs_tpu_torch/tools/flagship_1080p.py at its full size (1920x1080,
# 120,000 static + 120,000 dynamic, 12 frames), cut in depth to fit the
# script's time (FLAGSHIP_REDUCED)
FLAGSHIP_ARGS = ("--iters", "300", "--log_every", "50",
                 "--pose_noise_rot_deg", "0.5", "--pose_noise_trans", "0.025",
                 "--pose_prealign", "--prealign_steps", "25",
                 "--motion_masks", "--eval_w_align", "--w_align_steps", "200")
FLAGSHIP_REDUCED = ("300 joint iterations (the tool's default 400): both "
                    "models densify at 100, 200 and 300",
                    "pose pre-alignment 25 steps a level (250)",
                    "eval_w_align 200 pose steps (1000)")
FLAGSHIP_PROFILE_ITERATIONS = (304, 306)    # 305 is a rigidity iteration
KERNEL_EVENTS = {"expand": "expand_kernel", "tile_fwd": "tile_fwd_kernel",
                 "tile_bwd": "tile_bwd_kernel", "segsum": "segsum_kernel"}


def phase_flagship(device):
    """The flagship tool's `prepare`, `train` and `finish` at 1920x1080 with
    2 x 120,000 gaussians (FLAGSHIP_ARGS). Launch counters are zeroed just
    before `train` and read just after it; its history holds the profiles
    each iteration rendered at, so the expected counts are known: tile_fwd
    and tile_bwd twice an iteration, expand and segsum once a sort band of
    each render. Requires finite window losses and a static one that falls,
    no drops at the end, in the GT renders (escalated until nothing
    overflows) and in both PSNR renders (escalated from the trainer's
    dynamic profile; the drops at that profile are printed), and the
    alignment's L2 falling; then the four kernels against their plain
    versions on frame 0's concatenated render of the end state, each
    kernel's device time on that render beside its bound there, and
    torch.profiler over 3 iterations (one with rigidity) and one
    densification call of each model. Returns ({kernel: launches in
    train}, {kernel: max_abs_err}, {kernel: dict(ms, bound_ms, bound_by: on
    frame 0's render; train_ms_per_launch: the profiled iterations' mean
    over all their renders)}, the tool's median ms an iteration)."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.render.compact import split_profile
    from rodygs_tpu_torch.tools import flagship_1080p as FT
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    args = FT.build_parser().parse_args(list(FLAGSHIP_ARGS)
                                        + ["--device", device.type])
    log(f"[flagship] {args.width}x{args.height}, {args.n} static + {args.n} "
        f"dynamic gaussians; reduced from the tool's run: "
        f"{'; '.join(FLAGSHIP_REDUCED)}")
    prep = FT.prepare(args)
    joint, frames = prep.joint, prep.frames
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    hist = FT.train(joint, frames, args, prep.scene, prep.pose_noise)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    res, ev = FT.finish(args, prep, hist)
    W, H = args.width, args.height
    print(json.dumps(res), flush=True)

    profiles = hist["iteration_profiles"]
    bands = sum(split_profile(p)[1] for pair in profiles for p in pair)
    expected = {"expand": bands, "segsum": bands,
                "tile_fwd": 2 * len(profiles), "tile_bwd": 2 * len(profiles)}
    log(f"[flagship] train: {len(profiles)} iterations in {train_s:.2f} s, "
        f"step_ms_median {res['step_ms_median']} "
        f"(windows {res['window_ms']} ms), "
        f"{res['mpix_per_s_fwd_bwd']} Mpix/s fwd+bwd; launches {launches}, "
        f"expected {expected} ({bands} sort bands rendered)")
    log(f"[flagship] escalations {res['escalations']}; final profiles "
        f"{res['final_profiles']}; GT profile {ev['gt_profile']}")
    log(f"[flagship] window mean losses [it, static, dynamic] "
        f"{res['loss_traj']}; alive {res['alive_traj']}; RSS MB "
        f"{res['rss_traj_mb']}")
    pn = res["pose_noise"]
    log(f"[flagship] ATE init {pn['init_scores']['ATE']} -> prealign "
        f"{pn['prealign_scores']['ATE']} -> final "
        f"{pn['final_scores']['ATE']}; trajectory {pn['ate_traj']}; prealign "
        f"{pn['prealign']['per_view_s']} s a view, retry "
        f"{pn['prealign']['retry']}")
    log(f"[flagship] PSNR train {res['psnr_train_view']} held-out "
        f"{res['psnr_holdout_view']}; eval_w_align {res['eval_w_align']}; "
        f"dropped final {res['dropped_final']} eval {res['dropped_eval']} "
        f"(at the trainer's dynamic profile {res['final_profiles'][1]} the "
        f"two PSNR renders would drop "
        f"{res['dropped_eval_at_train_profile']}; rendered at "
        f"{ev['profiles']}); peak memory {res['peak_hbm_gb']} GiB "
        f"(torch.cuda.max_memory_allocated); fragment demand of view 0's "
        f"static render {res['fragment_demand_static_view0']}")
    require(launches == expected,
            f"flagship launches {launches} != expected {expected}")
    losses = [v for row in res["loss_traj"] for v in row[1:]]
    require(all(math.isfinite(v) for v in losses), "non-finite flagship loss")
    require(res["loss_traj"][-1][1] < res["loss_traj"][0][1],
            "the flagship static loss did not fall")
    require(res["dropped_final"] == [0, 0] and res["dropped_eval"] == [0, 0],
            "the flagship run still drops fragments")
    wa = res["eval_w_align"]
    require(wa["l2_aligned"] < wa["l2_nearest_init"],
            "the held-out view's L2 did not fall over the alignment")

    errs, s = check_concatenated(joint, FT.batch_for(frames, 0), W, H,
                                 "flagship", seed=6)
    # each kernel's least time at these shapes (`bound`, as the time phase
    # counts it) and its device time on the same render
    t0 = time.perf_counter()
    bounds, contrib, rejected, _ = tile_bounds(s)
    bounds.update(fragment_bounds(s, KC.slot_stats(s))[0])
    log(f"[flagship] bounds on that render ({contrib} contributing and "
        f"{rejected} rejected pixel-fragment pairs; counted in "
        f"{time.perf_counter() - t0:.2f} s): " + ", ".join(
            f"{k} {b:.4f} ms ({by})" for k, (b, by) in bounds.items()))
    calls = kernel_calls(s)
    on_render = {k: WARM_TIMER[k](fn) for k, fn in calls.items()}
    del s, calls
    for k, ms in on_render.items():
        log(f"[flagship] {k} on that render: {ms:.4f} ms "
            f"({WARM_TIMER[k].__name__}), {ms / bounds[k][0]:.2f}x its "
            f"bound {bounds[k][0]:.4f} ms")

    first, last = FLAGSHIP_PROFILE_ITERATIONS
    steps = last - first + 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in range(first, last + 1):
            b = FT.batch_for(frames, (it - 1) % FT.N_FRAMES)
            joint.train_iteration(b, b, it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    device_summary(prof, steps, wall_ms, "flagship profile")
    for name in ("motion_mlp", "rigidity_knn"):
        ms, n = range_device_ms(prof, name)
        log(f"[flagship profile] {name}: {ms:.4f} ms of device time in {n} "
            f"calls over iterations {first}-{last} (forward only)")
    per_launch = {}
    for name, key in KERNEL_EVENTS.items():
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and key in e.key]
        n = sum(e.count for e in hits)
        per_launch[name] = sum(dev_us(e) for e in hits) / 1e3 / max(n, 1)
        log(f"[flagship profile] {name}: {n} launches, "
            f"{per_launch[name]:.4f} ms of device time a launch (the mean "
            f"over these iterations' static-only and concatenated renders)")
    for name, trainer in (("static", joint.static), ("dynamic", joint.dynamic)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.densify(trainer.state, None)
            torch.cuda.synchronize()
        ms, _ = range_device_ms(prof, "densify_and_prune")
        log(f"[flagship profile] densify_and_prune of the {name} model "
            f"({G.capacity_of(trainer.state.store)} slots): {ms:.4f} ms of "
            f"device time")
    log(f"[flagship] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB allocated; phase {time.perf_counter() - t_phase:.2f} s; card "
        f"{res['device']}")
    return launches, errs, {k: dict(ms=on_render[k], bound_ms=bounds[k][0],
                                    bound_by=bounds[k][1],
                                    train_ms_per_launch=per_launch[k])
                            for k in bounds}, res["step_ms_median"]


# --------------------------------------------------------------------------
# scaling: the multi-device and sort tools
# --------------------------------------------------------------------------

# tools/scaling_bench.py's workloads: the JAX script's default, and the
# flagship's width at the 1080p render of phase 5b
SCALING_WORKLOADS = ((512, 512, 100_000), (1920, 1080, 240_000))
SCALING_ITERS = 10
SCALING_GLOO_ITERS = 3
SCALING_GLOO_MESHES = "2x1x1,1x2x1,1x1x2"
SCALING_TIMEOUT = 600.0
FOUR_CARD_CHECK_MESH = (2, 1, 2)
# part (f): the train CLI on four cards; iterations, snapshot, resume to
FOUR_CARD_CLI = (CLI_ITERATIONS, CLI_CHECKPOINT_EVERY, CLI_ITERATIONS + 50)


def scaling_sweep_rank(rank, argv):
    """One rank of a world that runs tools/scaling_bench.py's sweep."""
    from rodygs_tpu_torch.tools import scaling_bench as SB

    return SB.run(SB.build_parser().parse_args(argv))


def scaling_args(device, width, height, n, iters, profile, *extra):
    return ["--width", str(width), "--height", str(height),
            "--gaussians", str(n),
            "--iters", str(iters), "--fragment_profile", str(profile),
            "--device", device.type, *extra]


def log_sweep(tag, summary):
    for row in summary["meshes"]:
        short = {k: v for k, v in row.items() if k not in ("launches",)}
        log(f"[scaling] {tag} {json.dumps(short)}")
    require(not summary["failed"], f"scaling {tag}: meshes failed "
            f"{summary['failed']}")


def scaling_one_rank(device):
    """(a) The sweep at world size 1 through a 1-rank NCCL world, at both
    workloads; before each, the sharded step's first step against the
    trainer's own step on the same state (bit for bit). Returns ({workload:
    summary}, {workload: profile})."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from rodygs_tpu_torch.tools import scaling_bench as SB
    from rodygs_tpu_torch.train.trainer_static import ThreeDGSTrainer

    tmp = tempfile.mkdtemp(prefix="rodygs_scaling_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    out, profiles = {}, {}
    try:
        for width, height, n in SCALING_WORKLOADS:
            tag = f"{width}x{height}/{n}"
            t0 = time.perf_counter()
            store, poses, frames = SB.build_scene(n, width, height, 8,
                                                  device=device)
            profile, demand = SB.scene_profile(store, poses, frames, width,
                                               height)
            profiles[tag] = profile
            mesh, step, state, batch = SB.mesh_step(
                (1, 1, 1), store, poses, frames, width, height, device)
            cfg, loss = SB.static_setup(width, height)
            trainer = ThreeDGSTrainer(cfg, loss, store, poses, 3.0,
                                      device=device)
            active = loss.active_set(1)
            single, m1 = trainer.step(state, frames[0], 1.0, active, 3,
                                      profile)
            sharded, m2 = step(state, batch, 1.0, active, 3, profile)
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in zip(
                [*single.store.params, *single.poses, *single.opt.mu,
                 *single.opt.nu, *single.stats],
                [*sharded.store.params, *sharded.poses, *sharded.opt.mu,
                 *sharded.opt.nu, *sharded.stats]))
            log(f"[scaling] (a) {tag}: fragment demand {demand}, profile "
                f"{profile!r}; one NCCL rank ({mesh.backend}), the tool's "
                f"first step against the trainer's: params / poses / "
                f"moments / statistics bit-identical {exact}, loss "
                f"{float(m1['loss']):.7f} / {float(m2['loss']):.7f}")
            require(exact and float(m1["loss"]) == float(m2["loss"]),
                    f"scaling {tag}: the 1-rank step differs from the "
                    f"trainer's")
            del trainer, single, sharded, state, batch, step, mesh
            del store, poses, frames
            torch.cuda.empty_cache()
            summary = SB.run(SB.build_parser().parse_args(scaling_args(
                device, width, height, n, SCALING_ITERS, profile)))
            log_sweep(f"(a) {tag}", summary)
            base = summary["meshes"][0]
            require(all(v == SCALING_ITERS + 1
                        for v in base["launches"][0].values()),
                    f"scaling {tag}: launches {base['launches']} != "
                    f"{SCALING_ITERS + 1} of each kernel")
            log(f"[scaling] (a) {tag}: {time.perf_counter() - t0:.2f} s, "
                f"launches {base['launches'][0]}")
            out[tag] = summary
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out, profiles


def scaling_gloo(device, profile):
    """(b) The sweep in a 2-rank Gloo world sharing the card at 512x512 and
    fragment profile `profile`: correctness only. The tile- and
    gauss-sharded meshes' first loss must equal the baseline's (one frame);
    the data mesh's is the mean of two frames'."""
    from rodygs_tpu_torch.parallel.dryrun import run_world

    width, height, n = SCALING_WORKLOADS[0]
    t0 = time.perf_counter()
    argv = scaling_args(device, width, height, n, SCALING_GLOO_ITERS, profile,
                        "--meshes", SCALING_GLOO_MESHES)
    ranks = run_world(scaling_sweep_rank, 2, (argv,), backend="gloo",
                      timeout_s=SCALING_TIMEOUT)
    summary = ranks[0]
    log_sweep("(b) 2 Gloo ranks sharing one card (correctness, not a "
              "speed)", summary)
    rows = {tuple(r["mesh"].values()): r for r in summary["meshes"]}
    base = rows[(1, 1, 1)]["first_loss"][0]
    for shape, row in rows.items():
        require(all(math.isfinite(x) for x in row["first_loss"])
                and len(set(row["first_loss"])) == 1,
                f"scaling (b) {shape}: first losses {row['first_loss']}")
        require(all(v > 0 for r in row["launches"] for v in r.values()),
                f"scaling (b) {shape}: a kernel never launched")
        if shape[0] == 1:
            require(abs(row["first_loss"][0] - base) <= 1e-5 * base,
                    f"scaling (b) {shape}: first loss {row['first_loss'][0]}"
                    f" != the baseline's {base}")
    require(ranks[1]["meshes"] == summary["meshes"],
            "scaling (b): the ranks disagree on the rows")
    log(f"[scaling] (b) {time.perf_counter() - t0:.2f} s")
    return summary


def four_card_check_rank(rank, shape, width, height, n, profile,
                         device=None):
    """One rank of the four-card NCCL world: the 512x512 scene on mesh
    `shape`, the gradients of one sharded step at fragment profile
    `profile` with its kernel launches counted and its overflow flag; the
    all-reduce of those parameter gradients over the data axis and over
    all four ranks, timed (10 synchronised calls, the median); rank 0 holds
    the four kernels against their plain versions on its share of its
    render at the same profile (`kernel_check.check_tile_block`, as phase
    9c). On its own card unless `device` is "cpu" (a rehearsal)."""
    import torch
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch import kernels
    from rodygs_tpu_torch.parallel import collectives as PC
    from rodygs_tpu_torch.parallel.mesh import rank_device
    from rodygs_tpu_torch.parallel.sharded import composite_axes
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.tools import scaling_bench as SB
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses
    from rodygs_tpu_torch.utils.platform import device_label, resolve_device

    resolve_device(device or "cuda")
    dev = rank_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    store, poses, frames = SB.build_scene(n, width, height, 8, device=dev)
    mesh, step, state, batch = SB.mesh_step(shape, store, poses, frames,
                                            width, height, dev)
    kernels.reset_launches()
    grads = step.grads(state, batch, step.loss.active_set(1), 3, profile)
    sync()
    out = {"rank": rank, "coords": mesh.coords, "card": device_label(dev),
           "launches": dict(kernels.LAUNCHES), "loss": float(grads[0]),
           "overflow": bool(grads[4]), "fragments": int(grads[6]),
           "allreduce_mb": sum(g.numel() for g in grads[1]) * 4 / 2**20,
           "allreduce_ms": {}}
    for name, axis in (("data", mesh.axis("data")), ("world", mesh.world)):
        times = []
        for _ in range(11):
            sync()
            t0 = time.perf_counter()
            PC.psum(grads[1], axis)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"][f"{name} ({axis.size} ranks)"] = float(
            np.median(times[1:]))
    if rank == 0:
        comp = composite_axes(mesh)
        cam = make_camera_from_poses(poses, frames[mesh.coords["data"]])
        tiles = -(-width // 16) * -(-height // 16)
        s = KC.capture_stages(store.params, store.alive, cam, 3, width,
                              height, profile, _default_tight(tiles), 4)
        out["capture_overflow"] = bool(s["cb"].overflow)
        out["kernel_errs"] = KC.check_tile_block(s, comp.size, comp.index)
    return out


def scaling_four_card(device, profiles=None):
    """(e) Four cards, NCCL between them: the sweep over every
    factorisation of 4 under torchrun at both workloads,
    tools/multihost_smoke over 4 NCCL processes, and the four kernels on
    rank 0's share of a 2x1x2 step. Returns ({workload: summary}, per-rank
    launches summed over both sweeps, {kernel: max_abs_err})."""
    import os
    import tempfile
    import torch
    from rodygs_tpu_torch.parallel.dryrun import run_world
    from rodygs_tpu_torch.tools import scaling_bench as SB

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, RODYGS_DIST_BACKEND="nccl", OMP_NUM_THREADS="1")
    sweeps, launches = {}, [dict.fromkeys(SOURCES, 0) for _ in range(4)]
    for width, height, n in SCALING_WORKLOADS:
        tag = f"{width}x{height}/{n}"
        profile = (profiles or {}).get(tag)
        if profile is None:
            scene = SB.build_scene(n, width, height, 8, device=device)
            profile, _ = SB.scene_profile(*scene, width, height)
            del scene
            torch.cuda.empty_cache()
        profiles = {**(profiles or {}), tag: profile}
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "scaling.json"
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "4", "-m",
                 "rodygs_tpu_torch.tools.scaling_bench",
                 *scaling_args(device, width, height, n, SCALING_ITERS,
                               profile, "--out", str(out))],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=SCALING_TIMEOUT)
            wall = time.perf_counter() - t0
            for line in res.stdout.splitlines():
                if line.startswith("[scaling] rank"):
                    log(f"[scaling] (e) {tag} {line[len('[scaling] '):]}")
            if res.returncode != 0:
                log(res.stdout[-4000:] + res.stderr[-4000:])
            require(res.returncode == 0, f"four-card sweep {tag}: exit code "
                    f"{res.returncode}")
            summary = json.loads(out.read_text())
        log_sweep(f"(e) four cards over NCCL, {tag}, profile {profile!r} "
                  f"({wall:.2f} s wall)", summary)
        require(summary["n_devices"] == 4 and len(summary["meshes"]) == 7,
                f"four-card sweep {tag}: {len(summary['meshes'])} meshes")
        for row in summary["meshes"]:
            for r, counts in enumerate(row["launches"]):
                for k, v in counts.items():
                    launches[r][k] += v
        sweeps[tag] = summary

    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "rodygs_tpu_torch.tools.multihost_smoke",
         "--ranks", "4", "--backend", "nccl"], cwd=root, env=env,
        capture_output=True, text=True, timeout=2 * SCALING_TIMEOUT)
    for line in res.stdout.splitlines():
        if line.startswith(("[multihost]", "MULTIHOST_SMOKE")):
            log(f"[scaling] (e) {line}")
    if res.returncode != 0:
        log(res.stdout[-4000:] + res.stderr[-4000:])
    require(res.returncode == 0 and "MULTIHOST_SMOKE PASS" in res.stdout,
            f"multihost_smoke over 4 NCCL processes: exit code "
            f"{res.returncode}")
    log(f"[scaling] (e) multihost_smoke {time.perf_counter() - t0:.2f} s")

    width, height, n = SCALING_WORKLOADS[0]
    profile = profiles[f"{width}x{height}/{n}"]
    ranks = run_world(four_card_check_rank, 4, (FOUR_CARD_CHECK_MESH, width,
                                                height, n, profile),
                      backend="nccl", timeout_s=SCALING_TIMEOUT)
    for r in ranks:
        log(f"[scaling] (e) mesh {'x'.join(map(str, FOUR_CARD_CHECK_MESH))} "
            f"rank {r['rank']} {r['coords']} on {r['card']}, profile "
            f"{profile!r}: loss {r['loss']:.6f}, {r['fragments']} fragments "
            f"(overflow {r['overflow']}), launches {r['launches']}; NCCL "
            f"all-reduce of the {r['allreduce_mb']:.2f} MB parameter "
            f"gradients {json.dumps(r['allreduce_ms'])} ms")
        require(all(v == 1 for v in r["launches"].values()),
                f"rank {r['rank']}: launches {r['launches']}")
        require(not r["overflow"], f"four-card check: rank {r['rank']}'s "
                f"step overflows profile {profile!r}")
    require(not ranks[0]["capture_overflow"], f"four-card check: rank 0's "
            f"captured render overflows profile {profile!r}")
    errs = ranks[0]["kernel_errs"]
    log(f"[scaling] (e) the four kernels against their plain versions on "
        f"rank 0's share of its render: {errs}")
    require(len({r["loss"] for r in ranks}) == 1,
            "four-card check: the ranks disagree on the loss")
    require(all(v > 0 for r in launches for v in r.values()),
            f"four-card sweeps: a rank never launched a kernel {launches}")
    log(f"[scaling] (e) four-card part {time.perf_counter() - t_phase:.2f} s")
    return sweeps, launches, errs


def _rank_log(text):
    """What part (f) reads from one rank's train log: the logged
    iterations' (iteration, static loss, dynamic loss, N_static), the
    densification lines, the StepTimer summaries and the kernel launches
    of each run."""
    rows, dens = [], []
    for ln in text.splitlines():
        if "] static " in ln:
            it = int(ln.split("[")[-1].split("/")[0])
            f = ln.split("] static ")[1].split()
            rows.append((it, float(f[0]), float(f[2]), int(f[4])))
        elif "densify at " in ln:
            dens.append(ln.split("densify at ", 1)[1])
    jsons = {p: [json.loads(ln.split(p, 1)[1]) for ln in text.splitlines()
                 if p in ln] for p in ("step times ", "kernel launches ")}
    return rows, dens, jsons["step times "], jsons["kernel launches "]


def four_card_cli(device, one_card_p50):
    """(f) The train CLI under `torch.distributed.run --standalone
    --nproc_per_node 4` over NCCL, one card per rank, `--mesh data=4`, on
    the `cli` phase's scene: FOUR_CARD_CLI[0] iterations with a snapshot
    every FOUR_CARD_CLI[1] (both models densify at 600; the CLI bounds
    densify_until_iter by --num_iterations, so not at 700), then `--resume`
    to FOUR_CARD_CLI[2] with a snapshot at its end. Requires exit code 0
    for both calls, one run directory with one writer's files, a log per
    rank with its mesh row and the resume line, the same losses and store
    sizes on every rank, every kernel launched on every rank; the
    single-process port loads resume.ckpt with the static store of
    static_last.ckpt, the eval_wo_align CLI gives finite PSNR / SSIM /
    LPIPS (seeded LPIPS weights), and the four kernels hold against their
    plain versions on the end state's concatenated render on this card.
    Prints each rank's StepTimer p50 and the efficiency p50(one card) /
    p50(four cards), the slowest rank's. Returns (per-rank launches of the
    first run, {kernel: max_abs_err})."""
    import os
    import shutil
    import tempfile
    import torch
    import yaml
    from rodygs_tpu_torch.evalsuite.lpips import write_random_weights
    from rodygs_tpu_torch.models import gaussians as G
    from rodygs_tpu_torch.pipelines.build import (build_training_run,
                                                  make_frame_batch)
    from rodygs_tpu_torch.utils.checkpoint import load_checkpoint
    from rodygs_tpu_torch.utils.config import load_yaml

    t_part = time.perf_counter()
    iters, every, resume_to = FOUR_CARD_CLI
    root = Path(tempfile.mkdtemp(prefix="rodygs_four_cli_"))
    cpu = device.type == "cpu"      # the CPU rehearsal: Gloo processes
    backend = "gloo" if cpu else "nccl"
    env = dict(os.environ, RODYGS_DIST_BACKEND=backend, OMP_NUM_THREADS="1")
    try:
        data = write_cli_scene(root, device, "scaling (f)")
        runs = root / "logs" / "four"
        run = runs / "kubric_777" / "train"
        walls = []
        # the resumed run snapshots at its end, which the port then loads
        for n, every_, extra in ((iters, every, []),
                                 (resume_to, resume_to - iters, ["--resume"])):
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", "4", "-m",
                   "rodygs_tpu_torch.pipelines.train", "-d", str(data), "-b",
                   CLI_TRAIN_YAML, "-g", "four", "-n", "kubric", "-l",
                   str(root / "logs"), "--num_iterations", str(n),
                   "--checkpoint_every", str(every_), "--mesh", "data=4",
                   *extra, *(["--device", "cpu"] if cpu else [])]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                                 capture_output=True, text=True,
                                 timeout=SCALING_TIMEOUT, env=env)
            walls.append(time.perf_counter() - t0)
            if res.returncode != 0:
                log(res.stdout[-4000:] + res.stderr[-4000:])
            require(res.returncode == 0, f"four-card train CLI "
                    f"{' '.join(extra) or 'first run'}: exit code "
                    f"{res.returncode}")
        files = sorted(p.name for p in run.iterdir() if p.is_file())
        log(f"[scaling] (f) four cards over {backend}, --mesh "
            f"data=4: {iters} iterations in {walls[0]:.2f} s wall, --resume "
            f"to {resume_to} in {walls[1]:.2f} s; files {files}")
        want = {"train.log", "train.p1.log", "train.p2.log", "train.p3.log",
                "args.yaml", "config.yaml", "static_last.ckpt",
                "dynamic_last.ckpt", "resume.ckpt"}
        require(sorted(p.name for p in runs.iterdir()) == ["kubric_777"]
                and set(files) == want,
                f"not one run directory with one writer's files: {files}")
        ranks = []
        for i, name in enumerate(["train.log"] + [f"train.p{r}.log"
                                                  for r in (1, 2, 3)]):
            text = (run / name).read_text()
            require(f"at iteration {iters + 1}" in text
                    and "'data': %d" % i in text,
                    f"rank {i}'s log lacks its mesh row or the resume")
            rows, dens, steps, launches = _rank_log(text)
            require(len(steps) == 2 and len(launches) == 2,
                    f"rank {i}: {len(steps)} step summaries")
            ranks.append((rows, dens, steps, launches))
            log(f"[scaling] (f) rank {i}: StepTimer p50 "
                f"{[round(x['p50_ms'], 3) for x in steps]} ms (first run, "
                f"resumed run), p90 {[round(x['p90_ms'], 3) for x in steps]}"
                f"; launches of the first run {launches[0]}")
        rows0, dens0 = ranks[0][:2]
        log(f"[scaling] (f) rank 0: loss (iteration, static, dynamic, "
            f"N_static) {rows0[::4]}; densifications {dens0}")
        require(all(r[0] == rows0 for r in ranks),
                "the ranks disagree on the logged losses")
        require(all(r[1] == dens0 for r in ranks),
                "the ranks disagree on the densifications' store sizes")
        require([d.split(":")[0] for d in dens0] == ["600"]
                and all("static_store" in d and "dynamic_store" in d
                        for d in dens0),
                f"both models did not densify at 600 alone: {dens0}")
        require(all(math.isfinite(v) for row in rows0 for v in row[1:3])
                and rows0[-1][0] == resume_to,
                f"the losses are not finite to {resume_to}: {rows0[-3:]}")
        launches = [r[3][0] for r in ranks]
        require(all(v > 0 for ln in launches for v in ln.values()),
                f"a rank never launched a kernel {launches}")
        p50 = max(r[2][0]["p50_ms"] for r in ranks)
        log(f"[scaling] (f) efficiency of the joint iteration: "
            f"p50(one card, the cli phase) {one_card_p50:.3f} ms / "
            f"p50(four cards, the slowest rank) {p50:.3f} ms = "
            f"{one_card_p50 / p50:.4f} (each rank renders its own frame)")

        back = build_training_run(load_yaml(str(run / "config.yaml")),
                                  dirpath=str(data), capacity_factor=4.0,
                                  device=device)
        nxt = back.joint.load_resume(run / "resume.ckpt")
        end = load_checkpoint(run / "static_last.ckpt")[0]
        same = all(np.array_equal(v.cpu().numpy(), end["model"][k])
                   for k, v in G.to_state_dict(
                       back.joint.static.state.store).items())
        log(f"[scaling] (f) the single-process port loads resume.ckpt at "
            f"iteration {nxt}; the static store equals static_last.ckpt: "
            f"{same}")
        require(nxt == resume_to + 1 and same,
                "the single-process port did not load the four-card resume "
                "file")
        frame = back.dynamic_dm.get_train_dset()[0]
        errs, _ = check_concatenated(
            back.joint, make_frame_batch(frame, 0, device), CLI_SIZE,
            CLI_SIZE, "scaling (f)", seed=9)
        del back
        torch.cuda.empty_cache()

        weights = root / "lpips_seeded.npz"
        write_random_weights(weights)
        task = Path(CLI_EVAL_YAMLS[0]).stem
        _, secs = _cli(["rodygs_tpu_torch.pipelines.eval", "-c",
                        CLI_EVAL_YAMLS[0], "-d", data, "-m", run.parent, "-t",
                        task, "--eval_batch_size", 2, "--lpips_weights",
                        weights], f"eval CLI {task} on the four-card run",
                       timeout=300)
        viz = yaml.safe_load((run.parent / task / "result.yaml")
                             .read_text())["viz"]
        log(f"[scaling] (f) eval CLI {task} on the four-card run's "
            f"checkpoints {secs:.2f} s wall: {json.dumps(viz)}")
        for key in ("psnr", "ssim", "lpipsa", "lpipsv"):
            require(key in viz and math.isfinite(viz[key]),
                    f"{task} on the four-card run: {key} missing or not "
                    f"finite")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[scaling] (f) part {time.perf_counter() - t_part:.2f} s")
    return launches, errs


def phase_scaling(device, joint_ms, cli_p50):
    """Phase 11: the multi-device and sort tools on the card. (a) the
    scaling sweep at world size 1 over NCCL at both workloads, (b) in a
    2-rank Gloo world sharing the card, (c) the replicated dynamic work at
    262,144 slots against `joint_ms` (the flagship phase's ms an
    iteration), (d) the sort curve and one banded point; (e) and (f) with 4
    cards the four-card parts (the train CLI's efficiency against
    `cli_p50`, the `cli` phase's p50), else one line saying why they did
    not run. Returns (one-card launches {workload: {kernel: n}}, four-card
    per-rank launches of (e) and of (f) or None, {kernel: max_abs_err})."""
    import torch
    from rodygs_tpu_torch.tools import measure_dyn_replication as MDR
    from rodygs_tpu_torch.tools import sort_microbench as SM

    t_phase = time.perf_counter()
    sweeps, profiles = scaling_one_rank(device)
    width, height, n = SCALING_WORKLOADS[0]
    scaling_gloo(device, profiles[f"{width}x{height}/{n}"])

    t0 = time.perf_counter()
    rep = MDR.main(MDR.build_parser().parse_args(
        ["--joint_ms", str(joint_ms), "--device", device.type]))
    log(f"[scaling] (c) replicated dynamic work: {json.dumps(rep)} "
        f"({time.perf_counter() - t0:.2f} s)")
    require(all(rep[k] is not None and math.isfinite(rep[k]) and rep[k] > 0
                for k in ("deform_ms", "adam_ms", "share")),
            "measure_dyn_replication gave no time")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    curve = SM.curve(device=device)
    h = 4
    m = SM.band_extent(SM.HUGE_1080P, h)
    banded = SM.bench_banded(h, m, 10, SM.chain_2d, device=device)
    for name, c, ms in curve:
        log(f"[scaling] (d) sort {name:44s} C={c:>9,}  {ms:8.4f} ms/sort")
    log(f"[scaling] (d) sort bands={h} [{h},{m:,}] (key,iota,10rows) stable "
        f"{banded:8.4f} ms/sort ({time.perf_counter() - t0:.2f} s)")
    require(all(math.isfinite(ms) and ms > 0 for _, _, ms in curve)
            and math.isfinite(banded) and banded > 0, "a sort was not timed")
    torch.cuda.empty_cache()

    four, four_cli, errs = None, None, {}
    count = torch.cuda.device_count()
    if count >= 4:
        _, four, errs = scaling_four_card(device, profiles)
        four_cli, e_cli = four_card_cli(device, cli_p50)
        errs = {k: max(errs[k], e_cli[k]) for k in errs}
    else:
        for part in ("(e) the four-card run", "(f) the four-card train CLI"):
            log(f"[scaling] {part} was not run: {count} card(s) visible, it "
                f"needs 4 on one host (README)")
    log(f"[scaling] phase {time.perf_counter() - t_phase:.2f} s")
    one = {tag: s["meshes"][0]["launches"][0] for tag, s in sweeps.items()}
    return one, four, four_cli, errs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rodygs_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    from rodygs_tpu_torch.utils.platform import resolve_device

    device = resolve_device("cuda")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    secs = kernels.build_all()
    log(f"[build] {secs:.2f} s")
    for line in occupancy_lines(kernels.BUILD_LOG):
        log(line)

    errs = phase_check(device)
    trainer, batch_for, launches, iterations = phase_train(device)
    launches_bench, e_bench = phase_bench(device)
    from rodygs_tpu_torch import kernel_check as KC
    from rodygs_tpu_torch.render import compact as C
    from rodygs_tpu_torch.render.rasterize import _default_tight
    from rodygs_tpu_torch.train.trainer_static import make_camera_from_poses

    st = trainer.state
    phase_profile(trainer, batch_for, first_iteration=iterations + 1,
                  cap=C.fragment_capacity(st.store.params.xyz.shape[0],
                                          trainer.fragment_profile))
    cam = make_camera_from_poses(st.poses, batch_for(0))
    s = KC.capture_stages(st.store.params, st.store.alive, cam,
                       trainer.active_sh_degree, 512, 512,
                       trainer.fragment_profile, _default_tight(32 * 32), 2)
    e512 = KC.check_stages(s)
    log(f"[check] 512x512 trained state max_abs_err={e512}")
    timings = time_kernels(s)
    del s
    launches_legacy, launches_variants, e_var, legacy_ms = phase_variants(
        device, trainer, batch_for)
    e1080, t1080 = phase_1080p(device)
    del st
    torch.cuda.empty_cache()
    launches_joint, e_joint, joint_end = phase_joint(device)
    launches_eval, launches_bands, e_eval = phase_eval(device, joint_end)
    del joint_end
    torch.cuda.empty_cache()
    launches_cli, e_cli, cli_p50 = phase_cli(device)
    launches_multi, launches_torchrun, e_multi = phase_multi(
        device, trainer, batch_for)
    del trainer, batch_for
    torch.cuda.empty_cache()
    launches_flagship, e_flagship, t_flagship, flagship_ms = phase_flagship(
        device)
    torch.cuda.empty_cache()
    launches_scaling, launches_four_card, launches_four_cli, e_scaling = \
        phase_scaling(device, flagship_ms, cli_p50)

    rows = []
    for name in kernels.KERNELS:
        src, replaces = SOURCES[name]
        t = timings[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "launches_bench": {w: v[name] for w, v in
                                        launches_bench.items()},
                     "launches_legacy": launches_legacy[name],
                     "launches_variants": launches_variants[name],
                     "launches_joint": launches_joint[name],
                     "launches_eval": launches_eval[name],
                     "launches_bands": launches_bands[name],
                     "launches_cli": {c: v[name]
                                      for c, v in launches_cli.items()},
                     "launches_multi": [r[name] for r in launches_multi],
                     "launches_torchrun": [r[name]
                                           for r in launches_torchrun],
                     "launches_flagship": launches_flagship[name],
                     "launches_scaling": {w: v[name] for w, v in
                                          launches_scaling.items()},
                     "launches_four_card": None if launches_four_card is None
                     else [r[name] for r in launches_four_card],
                     "launches_four_card_cli": None
                     if launches_four_cli is None
                     else [r[name] for r in launches_four_cli],
                     "flagship": t_flagship[name],
                     "max_abs_err": max(errs[name], e512[name],
                                        e_bench[name],
                                        e_var.get(name, 0.0),
                                        e1080.get(name, 0.0), e_joint[name],
                                        e_eval[name], e_cli[name],
                                        e_multi[name], e_flagship[name],
                                        e_scaling.get(name, 0.0)),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        if name in t1080:    # the fragment kernels: cold readings, 1080p
            rows[-1].update(cold_ms=t["cold_ms"],
                            library_cold_ms=t["library_cold_ms"],
                            rows_1080p=t1080[name])
        else:                # the tile kernels: on the legacy records
            rows[-1].update(legacy_ms=legacy_ms[name])
        log(f"[time] {name}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), launches in "
            f"{iterations} steps "
            f"{launches[name]}, in the bench windows "
            f"{rows[-1]['launches_bench']}, in one legacy render "
            f"{launches_legacy[name]}, in the variants' four renders "
            f"{launches_variants[name]}, in "
            f"{JOINT_ITERATIONS[1] - JOINT_ITERATIONS[0] + 1} "
            f"joint iterations {launches_joint[name]}, inside eval() "
            f"{launches_eval[name]}, in the banded renders "
            f"{launches_bands[name]}, in the CLIs "
            f"{rows[-1]['launches_cli']}, per rank in the 4-rank world "
            f"{rows[-1]['launches_multi']}, per rank under torchrun "
            f"{rows[-1]['launches_torchrun']}, in the flagship run's "
            f"training {launches_flagship[name]}, in the one-card scaling "
            f"baselines {rows[-1]['launches_scaling']}, per rank in the "
            f"four-card sweeps {rows[-1]['launches_four_card']}, per rank "
            f"in the four-card train CLI "
            f"{rows[-1]['launches_four_card_cli']}")

    print(card_name_and_limit())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
