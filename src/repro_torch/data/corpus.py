"""The paper's imbalance model (footnote 5) as a compute-repeat grid.

A numpy copy of ``repro/data/corpus.py::imbalance_repeats``.
"""
from __future__ import annotations

import numpy as np


def imbalance_repeats(n_procs: int, tasks_per_proc: int, *,
                      mode: str = "balanced", hot_factor: int = 8,
                      hot_fraction: float = 0.125,
                      seed: int = 0) -> np.ndarray:
    """Per-(rank, task) compute-repeat factors.

    balanced:    every task runs once.
    unbalanced:  a ``hot_fraction`` of ranks runs each task ``hot_factor``
                 times (the paper's "same task computed multiple times,
                 input read once").
    random:      per-task repeat ~ U{1, hot_factor} — irregular datasets.
    """
    reps = np.ones((n_procs, tasks_per_proc), np.int32)
    if mode == "balanced":
        return reps
    if mode == "unbalanced":
        n_hot = max(1, int(round(n_procs * hot_fraction)))
        reps[:n_hot] = hot_factor
        return reps
    if mode == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(1, hot_factor + 1,
                            size=(n_procs, tasks_per_proc)).astype(np.int32)
    raise ValueError(mode)
