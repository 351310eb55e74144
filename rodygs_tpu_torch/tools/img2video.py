"""Frames -> mp4, for the Track-Anything UI (the reference's
`scripts/img2video.py:18-33`). Port of `scripts/img2video.py`, on
`utils/store.write_video`.

    python -m rodygs_tpu_torch.tools.img2video --input_dir <frames>
        --output <video.mp4> [--fps 30]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..utils.store import write_video


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.img2video",
        description="The *.png frames of a directory, in name order, as an "
                    "mp4.")
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--fps", type=int, default=30)
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    write_video(Path(args.input_dir), Path(args.output), fps=args.fps)
