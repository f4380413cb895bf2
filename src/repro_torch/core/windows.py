"""Windows and the engine carry, with the ranks as the leading dim.

Counterpart of ``repro/core/windows.py``. Every carry leaf has the host
layout of the reference's segmented carry (every leaf there gains a
leading shard dim), so a reference carry converts one to one
(:func:`carry_from_numpy` / :func:`carry_to_numpy`):

  ``table (P, V)``, ``pending_k/v (P, P, cap)``, ``status/cursor (P,)``,
  ``work/stolen (P, P)``, ``job_work (P, coslots)`` (one slot a member
  job of a WorkDomain; one for a solo job),
  ``owner_map/owner_split (P, V)``.

The dense window folds in place: the engine never keeps an old carry, so
a functional copy of the ``(P, V)`` table per fold would only cost bytes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kv import (KEY_SENTINEL, local_reduce, merge_sorted,
                                 owner_of)

STATUS_INIT = 0
STATUS_MAP = 1
STATUS_REDUCE = 2
STATUS_COMBINE = 3
STATUS_DONE = 4


class DenseWindow(NamedTuple):
    """Dense Key-Value windows: ``table[r, k]`` accumulates the value for
    key k held by rank r (non-owned slots stay 0)."""
    table: torch.Tensor          # (P, vocab) int32

    def put(self, keys: torch.Tensor, values: torch.Tensor) -> DenseWindow:
        """Fold ``(P, L)`` records into each rank's window, in place (the
        receive side of a one-sided put). Indexing follows the
        reference's scatter: sentinel and out-of-range keys are dropped,
        keys in [-V, 0) wrap to the end of the window."""
        V = self.table.shape[-1]
        idx = keys + torch.where(keys < 0, V, 0)
        hit = (keys != KEY_SENTINEL) & (idx >= 0) & (idx < V)
        self.table.scatter_add_(-1, torch.where(hit, idx, 0).long(),
                                torch.where(hit, values, 0))
        return self

    def to_records(self):
        """Per-rank (key, value) records: ``(P, V)`` keys ascending,
        KEY_SENTINEL where the window holds 0."""
        V = self.table.shape[-1]
        keys = torch.arange(V, dtype=torch.int32, device=self.table.device)
        valid = self.table != 0
        return (torch.where(valid, keys, KEY_SENTINEL),
                torch.where(valid, self.table, 0))


class SortedWindow(NamedTuple):
    """Generic Key-Value windows: sorted unique runs, merged on arrival.
    ``keys``/``values`` are ``(..., capacity)``, one row a rank."""
    keys: torch.Tensor            # (..., capacity) int32, KEY_SENTINEL padded
    values: torch.Tensor

    @staticmethod
    def alloc(capacity: int, dtype=torch.int32, lead: tuple = (),
              device=None) -> SortedWindow:
        """Empty windows of shape ``lead + (capacity,)``."""
        shape = tuple(lead) + (capacity,)
        return SortedWindow(
            torch.full(shape, KEY_SENTINEL, dtype=torch.int32,
                       device=device),
            torch.zeros(shape, dtype=dtype, device=device))

    def put(self, keys: torch.Tensor, values: torch.Tensor) -> SortedWindow:
        """Merge ``(..., L)`` key-ascending records into each row, summing
        duplicates; past ``capacity`` unique keys are dropped."""
        k, v = merge_sorted(self.keys, self.values, keys, values,
                            self.keys.shape[-1])
        return SortedWindow(k, v)


class EngineCarry(NamedTuple):
    table: torch.Tensor       # dense Key-Value windows (P, vocab)
    pending_k: torch.Tensor   # in-flight received chunk (P, P, cap)
    pending_v: torch.Tensor
    status: torch.Tensor      # (P,) STATUS_*
    cursor: torch.Tensor      # (P,) tasks completed
    work: torch.Tensor        # (P, P) work-stealing progress rows
    stolen: torch.Tensor      # (P, P) steal counters
    job_work: torch.Tensor    # (P, coslots) executed work per job slot
    owner_map: torch.Tensor   # (P, vocab) key -> base owner rank
    owner_split: torch.Tensor  # (P, vocab) replicas per key (>= 1)


def init_carry(spec, device) -> EngineCarry:
    P, cap, V = spec.n_procs, spec.push_cap, spec.vocab

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    # the hash rule as a dense map, one contiguous row per rank
    omap = owner_of(torch.arange(V, dtype=torch.int32, device=device), P)
    return EngineCarry(
        table=zeros(P, V),
        pending_k=torch.full((P, P, cap), KEY_SENTINEL, dtype=torch.int32,
                             device=device),
        pending_v=zeros(P, P, cap),
        status=torch.full((P,), STATUS_MAP, dtype=torch.int32,
                          device=device),
        cursor=zeros(P),
        work=zeros(P, P),
        stolen=zeros(P, P),
        job_work=zeros(P, spec.coslots),
        owner_map=omap.repeat(P, 1),
        owner_split=torch.ones((P, V), dtype=torch.int32, device=device),
    )


def carry_from_numpy(leaves, device) -> EngineCarry:
    """A carry from host arrays in the reference's segmented layout: an
    ``EngineCarry`` of the reference (its fields, in order, or by name),
    a mapping from field name, or a sequence in field order."""
    if hasattr(leaves, "_asdict"):
        leaves = leaves._asdict()
    if not isinstance(leaves, dict):
        leaves = dict(zip(EngineCarry._fields, leaves, strict=True))
    return EngineCarry(**{
        f: torch.as_tensor(np.ascontiguousarray(leaves[f], np.int32))
        .to(device) for f in EngineCarry._fields})


def carry_to_numpy(carry: EngineCarry) -> EngineCarry:
    """The carry as host int32 arrays, same layout (an ``EngineCarry``
    of numpy arrays). They are copies: the engine folds into the carry
    in place."""
    return EngineCarry(*(np.array(t.detach().cpu()) for t in carry))


def combine_records(table: torch.Tensor, spec):
    """Windows -> per-rank sorted records entering the Combine tree, at
    ``spec.combine_capacity`` W. Returns ``(keys, vals, overflow)``, the
    last the ``(P,)`` records each rank lost squeezing its window into W
    (0 whenever W covers the window)."""
    keys, vals = DenseWindow(table).to_records()
    W = spec.combine_capacity
    overflow = torch.zeros(table.shape[:-1], dtype=torch.int32,
                           device=table.device)
    if W != keys.shape[-1]:
        keys, vals, n_unique = local_reduce(keys, vals, W)
        overflow = (n_unique - W).clamp(min=0)
    return keys, vals, overflow
