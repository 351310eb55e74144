"""The fragment sort alone, as the port's binning runs it. Port of
`scripts/sort_microbench.py`, `sort_microbench2.py` and
`sort_microbench3.py`, one sweep each:

    python -m rodygs_tpu_torch.tools.sort_microbench [curve|banded|bands1d]
        [--iters 5] [--reps 10] [--quick] [--device cpu]

What is timed is what `render/compact.py::sort_fragments` does: a stable
`torch.sort` of the int32 fragment key, then the record rows gathered by
the permutation. The permutation is itself the sorted iota, so the JAX
scripts' iota operand adds no work here. Keys are `(tile << 19) |
depth` over 8,160 tiles (1920x1080), 19 depth bits, from the JAX scripts'
numpy draws, with float32 record rows.

  curve    the capacity sweep 2^21 .. 2^23 (5,760,000: the 1080p point at
           "huge") with the iota and 10 rows; at 5,760,000 the unstable
           variants (one key; the key and the iota as two keys, i.e. an
           int64 (key, iota) key), 0 / 5 / 13 rows, and the backward's
           shape (a unique permutation key and 10 rows, no iota).
  banded   H bands as one sort along the last axis of [H, C/H] keys (rows
           [H, 10, C/H]) for H = 1, 2, 4, 8 at 5,760,000 and H = 2, 4 at
           the 4,960,000 fit.
  bands1d  H separate 1-D sorts of C/H (how the port's sort bands run) for
           H = 2, 4, 8 at 4,960,256, and the [H, C/H] sort at H = 16, 32.

Each repetition's key depends on the one before (the sorted key xor the
first sorted row as int32), as in the JAX scripts' chained loop, so that
the repetitions run back to back on the device; a reading is CUDA events
around `--reps` repetitions over `--reps` (the host clock on the CPU), the
median of `--iters` readings after one warm-up chain.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..utils.platform import device_label, resolve_device

TILES = 8160                  # 120 x 68 tiles of 16 px: 1920x1080
DEPTH_BITS = 19
CURVE_CAPS = (1 << 21, 3 << 20, 1 << 22, 4_700_160, 5_300_224, 5_760_000,
              6_291_456, 1 << 23)
QUICK_CAPS = (1 << 22, 5_760_000)
HUGE_1080P = 5_760_000        # the settled "huge" capacity at 1080p
FIT_BANDED = 4_960_000        # the demand fit of the banded sweep
FIT_BANDS1D = 4_960_256       # the demand-fit total of the 1-D band sweep


def _keys(tile: np.ndarray, depth: np.ndarray) -> np.ndarray:
    return ((tile.astype(np.uint32) << DEPTH_BITS)
            | depth.astype(np.uint32)).astype(np.int32)


def make_inputs(c: int, n_rows: int, seed=0, device=None):
    """The 1-D inputs of `scripts/sort_microbench.py`: (key [C] int32,
    rows [max(n_rows, 1), C] float32)."""
    rng = np.random.default_rng(seed)
    tile = rng.integers(0, TILES, size=c).astype(np.uint32)
    depth = rng.integers(0, 1 << DEPTH_BITS, size=c).astype(np.uint32)
    rows = rng.standard_normal((max(n_rows, 1), c))
    return (torch.tensor(_keys(tile, depth), device=device),
            torch.tensor(rows, dtype=torch.float32, device=device))


def _key_rows(h: int, m: int, n_rows: int, tiles=TILES, device=None):
    """The banded inputs of `scripts/sort_microbench{2,3}.py`: (key [H, M]
    int32 over tiles // H tiles a band, rows [H, max(n_rows, 1), M])."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, max(tiles // h, 1), size=(h, m)).astype(np.uint32)
    depth = rng.integers(0, 1 << DEPTH_BITS, size=(h, m)).astype(np.uint32)
    rows = rng.standard_normal((h, max(n_rows, 1), m))
    return (torch.tensor(_keys(tile, depth), device=device),
            torch.tensor(rows, dtype=torch.float32, device=device))


def sort_1d(key, rows, n_rows: int, stable=True, num_keys=1):
    """One sort of (key, iota, rows[:n_rows]) by the key, as
    `sort_fragments` runs it (`torch.sort`, then the rows gathered by the
    permutation): (sorted key, the permutation = the sorted iota, sorted
    rows [n_rows, C]). `num_keys=2` sorts by (key, iota) as one int64
    key."""
    by = key
    if num_keys == 2:
        by = (key.to(torch.int64) << 32) | torch.arange(key.shape[0],
                                                        device=key.device)
    out, perm = torch.sort(by, stable=stable)
    out_key = out if num_keys == 1 else (out >> 32).to(torch.int32)
    return out_key, perm, rows[:n_rows][:, perm]


def sort_2d(key, rows, n_rows: int):
    """One stable sort along the last axis of [H, M] keys, the rows [H,
    n_rows, M] gathered by its permutation: (sorted key, permutation,
    sorted rows)."""
    out_key, perm = torch.sort(key, dim=1, stable=True)
    rows = rows[:, :n_rows]
    idx = perm[:, None, :].expand(-1, rows.shape[1], -1)
    return out_key, perm, torch.gather(rows, 2, idx)


def chain_1d(key, rows, n_rows, reps, stable=True, num_keys=1,
             with_iota=True):
    """`reps` data-dependent 1-D sorts (the JAX scripts' chained loop):
    the next key is the sorted key xor the first sorted row as int32, or,
    without rows, xor the sorted iota (the repetition's index without
    it)."""
    for i in range(reps):
        out_key, perm, out_rows = sort_1d(key, rows, n_rows, stable,
                                          num_keys)
        if n_rows:
            key, rows = out_key ^ out_rows[0].to(torch.int32), out_rows
        else:
            key = out_key ^ (perm.to(torch.int32) if with_iota else i)
    return key, rows


def chain_2d(key, rows, n_rows, reps):
    """`reps` data-dependent [H, M] sorts."""
    for _ in range(reps):
        out_key, _, rows = sort_2d(key, rows, n_rows)
        key = out_key ^ rows[:, 0].to(torch.int32)
    return key, rows


def chain_unrolled(key, rows, n_rows, reps):
    """`reps` rounds of H separate data-dependent 1-D sorts."""
    keys, rows = list(key), list(rows)
    for _ in range(reps):
        for b in range(len(keys)):
            out_key, _, out_rows = sort_1d(keys[b], rows[b], n_rows)
            keys[b], rows[b] = out_key ^ out_rows[0].to(torch.int32), out_rows
    return torch.stack(keys), torch.stack(rows)


def chain_ms(chain, reps: int, iters: int, device: torch.device) -> float:
    """ms per repetition of `chain(reps)`: the median of `iters` readings
    after one warm-up chain."""
    chain(reps)
    ts = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(reps)
            end.record()
            torch.cuda.synchronize(device)
            ts.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            chain(reps)
            ts.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(ts))


def bench(c, n_rows, *, stable=True, num_keys=1, with_iota=True, reps=10,
          iters=5, device=None):
    key, rows = make_inputs(c, n_rows, device=device)
    return chain_ms(lambda r: chain_1d(key, rows, n_rows, r, stable=stable,
                                       num_keys=num_keys,
                                       with_iota=with_iota),
                    reps, iters, key.device)


def bench_banded(h, m, n_rows, chain, reps=10, iters=5, device=None):
    key, rows = _key_rows(h, m, n_rows, device=device)
    return chain_ms(lambda r: chain(key, rows, n_rows, r), reps, iters,
                    key.device)


def band_extent(total: int, h: int) -> int:
    """Slots a band of `total` split H ways, 512-aligned."""
    return -(-total // (h * 512)) * 512


def curve(reps=10, iters=5, quick=False, device=None) -> list:
    """The capacity sweep and the variants at 5,760,000: [(name, C, ms)]."""
    kw = dict(reps=reps, iters=iters, device=device)
    out = []
    for c in (QUICK_CAPS if quick else CURVE_CAPS):
        out.append(("shipped(stable,1key,iota+10rows)", c, bench(c, 10, **kw)))
    c0 = HUGE_1080P
    out.append(("unstable,2keys(key,iota)+10rows", c0,
                bench(c0, 10, stable=False, num_keys=2, **kw)))
    out.append(("unstable,1key,iota+10rows", c0,
                bench(c0, 10, stable=False, **kw)))
    for n_rows in (0, 5, 13):
        out.append((f"stable,1key,iota+{n_rows}rows", c0,
                    bench(c0, n_rows, **kw)))
    out.append(("bwd-unsort stable 1key+10rows", c0,
                bench(c0, 10, with_iota=False, **kw)))
    out.append(("bwd-unsort unstable 1key+10rows", c0,
                bench(c0, 10, stable=False, with_iota=False, **kw)))
    return out


def banded(reps=10, iters=5, device=None, bands=(1, 2, 4, 8),
           fit_bands=(2, 4)) -> list:
    """[H, C/H] sorts at 5,760,000 and at the 4.96M fit: [(name, C, ms)]."""
    out = []
    for total, hs, tag in ((HUGE_1080P, bands, ""),
                           (FIT_BANDED, fit_bands, " fit-4.96M")):
        for h in hs:
            m = band_extent(total, h)
            out.append((f"bands={h} [{h},{m:,}] (key,iota,10rows) stable"
                        f"{tag}", h * m, bench_banded(h, m, 10, chain_2d,
                                                      reps, iters, device)))
    return out


def bands1d(reps=10, iters=5, device=None) -> list:
    """H separate 1-D sorts, and the [H, C/H] sort at H = 16, 32."""
    out = []
    for h in (2, 4, 8):
        m = band_extent(FIT_BANDS1D, h)
        out.append((f"unrolled {h} x 1D[{m:,}]", h * m,
                    bench_banded(h, m, 10, chain_unrolled, reps, iters,
                                 device)))
    for h in (16, 32):
        m = band_extent(FIT_BANDS1D, h)
        out.append((f"2d [{h},{m:,}]", h * m,
                    bench_banded(h, m, 10, chain_2d, reps, iters, device)))
    return out


SWEEPS = {"curve": curve, "banded": banded, "bands1d": bands1d}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.sort_microbench",
        description="Time the port's fragment sort (stable torch.sort and "
                    "the record gather) at the 1080p capacities.")
    p.add_argument("sweep", nargs="?", default="curve", choices=sorted(SWEEPS))
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--quick", action="store_true",
                   help="curve: two capacities only")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"[sort] {device_label(dev)}; torch {torch.__version__}",
          flush=True)
    kw = dict(reps=args.reps, iters=args.iters, device=dev)
    if args.sweep == "curve":
        kw["quick"] = args.quick
    rows = SWEEPS[args.sweep](**kw)
    for name, c, ms in rows:
        print(f"{name:44s} C={c:>9,}  {ms:8.3f} ms/sort", flush=True)
    return rows


if __name__ == "__main__":
    main()
