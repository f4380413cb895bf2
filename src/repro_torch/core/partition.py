"""Reduce-side partitioning: key→owner maps and the owner lookup.

Counterpart of ``repro/core/partition.py``. The owner map and the
per-key replica counts ride the carry as ``(P, vocab)`` tensors.
``HashPartitioner`` (the paper's ``hash(key) % P``, materialized as a
dense map) is the one partitioner of this port so far; the sampled
partitioners raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.kv import KEY_SENTINEL, mix32, owner_of

_NOT_PORTED = ("the sampled partitioners (and their planner pre-pass) are "
               "not ported yet: ROADMAP Queue 1 item 6")


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


def resolve_partitioner(p) -> Partitioner:
    """Name or instance -> instance. ``"hash"`` resolves; the sampled
    partitioners raise NotImplementedError (not ported yet)."""
    if isinstance(p, str):
        if p == "hash":
            return HashPartitioner()
        if p in ("sampled", "sampled+split"):
            raise NotImplementedError(f"partitioner {p!r}: {_NOT_PORTED}")
        raise ValueError(f"unknown partitioner {p!r}; available: ['hash', "
                         "'sampled', 'sampled+split'] (or pass a "
                         "Partitioner instance)")
    if not isinstance(p, Partitioner):
        raise TypeError(f"not a Partitioner: {p!r}")
    if p.needs_sample:
        raise NotImplementedError(f"partitioner {p.name!r}: {_NOT_PORTED}")
    return p


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
