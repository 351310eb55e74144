"""Frame samplers. Port of `rodygs_tpu/data/sampler.py` (numpy,
unchanged): the same seeded `np.random.default_rng` draws, so the frame
order equals the JAX package's.

Host-side index generators; the training loop turns indices into
`FrameBatch`es on the device.
"""

from __future__ import annotations

import numpy as np


class PermutationSampler:
    """Infinite stream of frame indices: a fresh random permutation per
    epoch."""

    def __init__(self, dataset, num_iterations: int | None = None, seed: int = 0):
        self.dataset = dataset
        self.num_iterations = num_iterations
        self._rng = np.random.default_rng(seed)
        self._queue: list[int] = []

    def __iter__(self):
        count = 0
        while self.num_iterations is None or count < self.num_iterations:
            if not self._queue:
                self._queue = list(self._rng.permutation(len(self.dataset)))
            yield self._queue.pop(0)
            count += 1

    def __len__(self):
        return self.num_iterations or 0


class SequentialSampler:
    """One sequential pass."""

    def __init__(self, dataset, **kwargs):
        self.dataset = dataset

    def __iter__(self):
        return iter(range(len(self.dataset)))

    def __len__(self):
        return len(self.dataset)


class WarmupSampler:
    """Incremental frame registration: sampling is restricted to the first
    `num_registered` frames, grown via `register_frame()`."""

    is_incremental = True

    def __init__(self, dataset, num_iterations: int | None = None,
                 num_initial: int = 1, seed: int = 0):
        self.dataset = dataset
        self.num_iterations = num_iterations
        self.num_registered = min(num_initial, len(dataset))
        self._rng = np.random.default_rng(seed)

    def register_frame(self):
        self.num_registered = min(self.num_registered + 1, len(self.dataset))

    def __iter__(self):
        count = 0
        while self.num_iterations is None or count < self.num_iterations:
            yield int(self._rng.integers(0, self.num_registered))
            count += 1
