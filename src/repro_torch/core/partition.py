"""Skew-aware reduce partitioning: key→owner maps and the owner lookup.

Counterpart of ``repro/core/partition.py``. A partitioner builds a dense
**owner map** (``owner_map[key] -> rank``) and a **split map**
(``owner_split[key] = k`` replicas for hot keys) on the host, in numpy,
equal to the reference's bit for bit; both ride the carry as
``(P, vocab)`` tensors, so one engine (and one set of step graphs)
serves every map and a checkpoint holds the map.

  * :class:`HashPartitioner` — the paper's ``hash(key) % P`` as a dense
    map. The default.
  * :class:`SampledPartitioner` — greedy LPT bin-packing of the keys
    observed in a planner pre-pass (:func:`sample_key_histogram` over a
    few tasks read through the job's feed); ``split=True`` spreads a hot
    key over ``k > 1`` consecutive owners, picked by task id in
    :func:`lookup_owner`. Combine's dup-sum keeps every map exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.kv import KEY_SENTINEL, mix32, owner_of


@runtime_checkable
class Partitioner(Protocol):
    """Key→owner assignment strategy for the reduce side."""

    name: str
    needs_sample: bool      # True -> a planner pre-pass builds the map

    def build(self, hist: np.ndarray,
              n_procs: int) -> tuple[np.ndarray, np.ndarray]:
        """(owner_map, owner_split) int32 arrays of shape (vocab,)."""
        ...


def hash_owner_map(vocab: int, n_procs: int) -> np.ndarray:
    """The paper's modulo rule as a dense map — equal to ``owner_of`` on
    every key in [0, vocab)."""
    return owner_of(torch.arange(vocab, dtype=torch.int32), n_procs).numpy()


@dataclass(frozen=True)
class HashPartitioner:
    """Static ``hash(key) % P`` — the default, zero pre-pass cost."""

    name = "hash"
    needs_sample = False

    def build(self, hist, n_procs: int):
        vocab = len(hist)
        return hash_owner_map(vocab, n_procs), np.ones((vocab,), np.int32)


@dataclass(frozen=True)
class SampledPartitioner:
    """Balanced owner map from a sampled key histogram.

    Greedy LPT: observed keys, heaviest first, each to the currently
    least-loaded rank. With ``split=True`` a key heavier than
    ``split_threshold`` × (total/P) is divided across
    ``k = ceil(load / threshold)`` consecutive ranks (capped at
    ``max_split`` or P); the base rank is chosen to minimize the
    resulting max load. Unobserved keys keep their hash owner.
    """

    sample_tasks: int = 16
    split: bool = False
    max_split: int = 0            # 0 -> n_procs
    split_threshold: float = 0.5  # fraction of the per-rank target load

    needs_sample = True

    @property
    def name(self) -> str:
        return "sampled+split" if self.split else "sampled"

    def build(self, hist, n_procs: int):
        hist = np.asarray(hist, np.float64)
        vocab = len(hist)
        omap = hash_owner_map(vocab, n_procs)
        osplit = np.ones((vocab,), np.int32)
        total = float(hist.sum())
        if total <= 0 or n_procs <= 1:
            return omap, osplit
        omap = omap.copy()
        load = np.zeros((n_procs,), np.float64)
        order = np.argsort(-hist, kind="stable")
        order = order[hist[order] > 0]
        chunk = max(self.split_threshold * total / n_procs, 1.0)
        cap = self.max_split or n_procs
        spans = (np.arange(n_procs)[:, None] + np.arange(cap)) % n_procs
        for key in order.tolist():
            c = float(hist[key])
            k = min(cap, int(np.ceil(c / chunk))) if self.split else 1
            if k > 1:
                share = c / k
                span = spans[:, :k]
                base = int(np.argmin(load[span].max(axis=1) + share))
                omap[key], osplit[key] = base, k
                load[span[base]] += share
            else:
                b = int(np.argmin(load))
                omap[key] = b
                load[b] += c
        return omap, osplit


_NAMED = {
    "hash": HashPartitioner(),
    "sampled": SampledPartitioner(),
    "sampled+split": SampledPartitioner(split=True),
}


def available_partitioners():
    return sorted(_NAMED)


def resolve_partitioner(p: str | Partitioner) -> Partitioner:
    """Name or instance -> instance, with a clear error on unknowns."""
    if isinstance(p, str):
        if p not in _NAMED:
            raise ValueError(f"unknown partitioner {p!r}; available: "
                             f"{available_partitioners()} (or pass a "
                             "Partitioner instance)")
        return _NAMED[p]
    if not isinstance(p, Partitioner):
        raise TypeError(f"not a Partitioner: {p!r}")
    return p


def fold_owner_map(owner_map, owner_split,
                   n_new: int) -> tuple[np.ndarray, np.ndarray]:
    """Project a key→owner assignment onto ``n_new`` ranks: owners wrap
    modulo the new rank count and split widths clamp to it (any total map
    is exact, so folding keeps a sampled map's balance without a new
    pre-pass)."""
    omap = np.asarray(owner_map, np.int32) % np.int32(n_new)
    osplit = np.clip(np.asarray(owner_split, np.int32), 1, n_new)
    return omap, osplit.astype(np.int32)


def sample_key_histogram(read_tasks_fn, plan, usecase, n_sample: int,
                         window: int = 0) -> np.ndarray:
    """Histogram the keys of up to ``n_sample`` tasks spread evenly over
    the input: the load proxy :meth:`Partitioner.build` consumes.

    ``read_tasks_fn(ids)`` serves token blocks by global task id (pass
    ``feed.sample_tasks`` so the read lands in the feed's stats). The
    use-case's ``map_emit`` runs on the sampled tasks as CPU tensors, one
    row a task, and each task counts every distinct key it emits once (a
    task pushes at most one record per key after its local reduce).
    ``window`` sizes the histogram (the engine's window; 0 falls back to
    ``usecase.window``)."""
    window = int(window) or usecase.window
    hist = np.zeros((window,), np.int64)
    if plan.n_tasks <= 0:
        return hist
    n = max(1, min(int(n_sample), plan.n_tasks))
    ids = np.unique(np.linspace(0, plan.n_tasks - 1, n).round()
                    .astype(np.int64)).astype(np.int32)
    tokens = np.asarray(read_tasks_fn(ids), np.int32)
    keys = usecase.map_emit(torch.from_numpy(tokens),
                            torch.from_numpy(ids))[0].numpy()
    # distinct valid keys a row: invalid keys sort past the window
    keys = np.sort(np.where((keys != KEY_SENTINEL) & (keys >= 0)
                            & (keys < window), keys, window), axis=-1)
    first = np.ones(keys.shape, bool)
    first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    keys = keys[first & (keys < window)]
    return hist + np.bincount(keys, minlength=window)


def lookup_owner(owner_map: torch.Tensor, owner_split: torch.Tensor,
                 keys: torch.Tensor, task_id: torch.Tensor,
                 n_procs: int) -> torch.Tensor:
    """Owner of each key of ``keys (P, ..., L)`` under each rank's dense
    ``(owner_map, owner_split)`` row, for the task ``task_id (P, ...)``
    of each row of records.

    Split keys (``owner_split[key] = k > 1``) resolve to one of the k
    consecutive replica ranks ``(base + j) % P``, picked by the mixed
    task id (task id -1 mixes as 0xFFFFFFFF). Invalid keys (sentinel /
    out of window) map to the ghost owner ``n_procs``.
    """
    vocab = owner_map.shape[-1]
    valid = (keys != KEY_SENTINEL) & (keys >= 0) & (keys < vocab)
    idx = torch.where(valid, keys, 0).long().reshape(keys.shape[0], -1)
    base = owner_map.gather(-1, idx).view(keys.shape)
    k = owner_split.gather(-1, idx).view(keys.shape).clamp(min=1)
    pick = (mix32(task_id).unsqueeze(-1) % k).to(torch.int32)
    owner = (base + torch.where(k > 1, pick, 0)) % n_procs
    return torch.where(valid, owner, n_procs)


def owner_loads(hist, owner_map, owner_split, n_procs: int) -> np.ndarray:
    """Expected records per owner under a map: split keys contribute
    ``hist/k`` to each of their k replica ranks."""
    hist = np.asarray(hist, np.float64)
    load = np.zeros((n_procs,), np.float64)
    for key in np.nonzero(hist > 0)[0].tolist():
        k = max(int(owner_split[key]), 1)
        share = hist[key] / k
        for j in range(k):
            load[(int(owner_map[key]) + j) % n_procs] += share
    return load
