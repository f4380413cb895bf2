"""Synthetic PUMA-like corpus and the paper's imbalance models.

Numpy copies of ``repro/data/corpus.py``: a Zipf word-law token stream
(the statistically relevant property of PUMA-Wikipedia) and the
compute-repeat grids (footnote 5: a task is *computed* r times while
its input is read once), and the LM training stream. Each gives the reference's arrays for the same
arguments and seed.
"""
from __future__ import annotations

import numpy as np


def zipf_tokens(n: int, vocab: int, a: float = 1.3, seed: int = 0,
                dtype=np.int32) -> np.ndarray:
    """Zipf-distributed token ids in [0, vocab). a≈1.3 matches natural text."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, size=n) % vocab).astype(dtype)


def synth_corpus(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    return zipf_tokens(n_tokens, vocab, seed=seed)


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


def zipf_skew_repeats(n_procs: int, tasks_per_proc: int, s: float, *,
                      mean_rep: int = 4, seed: int = 0) -> np.ndarray:
    """Key-distribution skew as a repeat grid (Fan et al.,
    arXiv:1401.0355): a budget of about ``n_procs * tasks_per_proc *
    mean_rep`` repeats spread over the ranks by a Zipf law of exponent
    ``s``, so every task of a hot rank is hot. A per-task jitter of 0 or
    +1 keeps a rank's tasks apart, and each task runs at least once.
    """
    assert s >= 0.0
    weights = (np.arange(1, n_procs + 1, dtype=np.float64)) ** (-s)
    weights /= weights.sum()
    budget = float(n_procs * tasks_per_proc * mean_rep)
    per_rank = np.maximum(1.0, budget * weights / tasks_per_proc)
    rng = np.random.default_rng(seed)
    jitter = rng.integers(0, 2, size=(n_procs, tasks_per_proc))
    reps = np.round(per_rank[:, None]).astype(np.int64) + jitter
    return np.maximum(reps, 1).astype(np.int32)


def lm_token_stream(n_tokens: int, vocab: int, seed: int = 0) -> np.ndarray:
    """Token stream for LM training (markov-flavoured Zipf, so the model
    has something learnable)."""
    rng = np.random.default_rng(seed)
    base = zipf_tokens(n_tokens, vocab, seed=seed)
    # inject local structure: with p=0.3, repeat the previous token + 1
    mask = rng.random(n_tokens) < 0.3
    shifted = np.roll(base, 1) + 1
    return np.where(mask, shifted % vocab, base).astype(np.int32)
