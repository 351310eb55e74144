"""Logging and reproducibility helpers. Port of
`rodygs_tpu/utils/logging_utils.py` (`seed_all`, `StreamToLogger`,
`set_logger`); `seed_all` also seeds torch's global generators. The
trainers draw from their own seeded `torch.Generator`s, not from these."""

from __future__ import annotations

import logging
import os
import random
import sys
from pathlib import Path

import numpy as np
import torch


def seed_all(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)


class StreamToLogger:
    """File-like that pipes writes into a logger (stdout/stderr redirect)."""

    def __init__(self, logger: logging.Logger, level: int = logging.INFO):
        self.logger = logger
        self.level = level
        self._buf = ""

    def write(self, message: str):
        self._buf += message
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.strip():
                self.logger.log(self.level, line.rstrip())

    def flush(self):
        if self._buf.strip():
            self.logger.log(self.level, self._buf.rstrip())
        self._buf = ""


def set_logger(logdir: str | Path, name: str = "train",
               redirect_streams: bool = False) -> logging.Logger:
    """Console + `<logdir>/<name>.log` file logger."""
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"rodygs_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    for handler in (logging.StreamHandler(sys.__stdout__),
                    logging.FileHandler(logdir / f"{name}.log")):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    if redirect_streams:
        sys.stdout = StreamToLogger(logger, logging.INFO)
        sys.stderr = StreamToLogger(logger, logging.ERROR)
    return logger
