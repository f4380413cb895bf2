"""Built-in scenarios for the Job API, each with a numpy oracle.

Counterpart of ``repro/core/usecases.py``; ``map_emit`` takes
``tokens (P, S)`` and ``task_id (P,)``:

  * :class:`WordCount`     — the paper's §3.1 PUMA benchmark: <token, 1>.
  * :class:`Histogram`     — bin token ids into B buckets: <bin, 1>.
  * :class:`InvertedIndex` — posting lists with term frequencies for a
                             query set: <doc·|Q|+q, 1>, documents made of
                             consecutive tasks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.kv import KEY_SENTINEL


@dataclass(frozen=True)
class WordCount:
    """<token, 1>: counts occurrences of each token id."""
    vocab: int

    @property
    def window(self) -> int:
        return self.vocab

    def map_emit(self, tokens, task_id):
        return tokens, (tokens != KEY_SENTINEL).to(torch.int32)


def wordcount_oracle(tokens, vocab: int) -> dict[int, int]:
    """numpy reference: exact counts over the whole input."""
    tokens = np.asarray(tokens)
    tokens = tokens[tokens != KEY_SENTINEL]
    counts = np.bincount(tokens, minlength=vocab)
    keys = np.nonzero(counts)[0]
    return {int(k): int(counts[k]) for k in keys}


@dataclass(frozen=True)
class Histogram:
    """<bin, 1>: equal-width histogram of token ids over [0, vocab)."""
    vocab: int
    n_bins: int

    @property
    def window(self) -> int:
        return self.n_bins

    def __post_init__(self):
        # bin mapping is computed in int32, as in the reference
        assert self.vocab * self.n_bins < 2 ** 31, "vocab*n_bins overflows"

    def map_emit(self, tokens, task_id):
        valid = tokens != KEY_SENTINEL
        bins = torch.where(valid, tokens, 0) * self.n_bins // self.vocab
        keys = torch.where(valid, bins, KEY_SENTINEL)
        return keys, valid.to(torch.int32)

    def finalize(self, records: dict[int, int]) -> np.ndarray:
        out = np.zeros((self.n_bins,), np.int64)
        for b, c in records.items():
            out[b] = c
        return out


def histogram_oracle(tokens, vocab: int, n_bins: int) -> np.ndarray:
    tokens = np.asarray(tokens)
    tokens = tokens[tokens != KEY_SENTINEL]
    bins = tokens.astype(np.int64) * n_bins // vocab
    return np.bincount(bins, minlength=n_bins).astype(np.int64)


@dataclass(frozen=True)
class InvertedIndex:
    """Posting lists for a query set: key = doc · |Q| + query_index, a
    document being ``tasks_per_doc`` consecutive Map tasks."""
    queries: tuple          # token ids to index (hashable for dataclass)
    n_docs: int
    tasks_per_doc: int

    @property
    def window(self) -> int:
        return self.n_docs * len(self.queries)

    def map_emit(self, tokens, task_id):
        # one compare a query against a scalar: no host-to-device copy,
        # so the map can be captured in the fused step's CUDA graph
        eq = torch.stack([tokens == int(q) for q in self.queries],
                         dim=-1)                            # (P, S, Q)
        # first matching query (argmax keeps first-index ties; it
        # refuses bool, hence the cast)
        qidx = eq.to(torch.uint8).argmax(dim=-1).to(torch.int32)
        task_id = task_id.unsqueeze(-1)
        hit = eq.any(dim=-1) & (tokens != KEY_SENTINEL) & (task_id >= 0)
        doc = (task_id // self.tasks_per_doc).clamp(0, self.n_docs - 1)
        keys = torch.where(hit, doc * len(self.queries) + qidx,
                           KEY_SENTINEL)
        return keys.to(torch.int32), hit.to(torch.int32)

    def finalize(self, records: dict[int, int]) -> dict[int, dict[int, int]]:
        """{query_token: {doc: term_frequency}} — sparse posting lists."""
        out: dict[int, dict[int, int]] = {int(t): {} for t in self.queries}
        Q = len(self.queries)
        for k, v in records.items():
            doc, qidx = divmod(int(k), Q)
            out[int(self.queries[qidx])][doc] = int(v)
        return out


def inverted_index_oracle(tokens, queries, task_size: int,
                          tasks_per_doc: int, n_docs: int):
    """numpy reference mirroring the planner's task slicing."""
    tokens = np.asarray(tokens)
    out = {int(t): {} for t in queries}
    n_tasks = (len(tokens) + task_size - 1) // task_size
    for t in range(n_tasks):
        doc = min(t // tasks_per_doc, n_docs - 1)
        chunk = tokens[t * task_size: (t + 1) * task_size]
        chunk = chunk[chunk != KEY_SENTINEL]
        for q in queries:
            n = int((chunk == q).sum())
            if n:
                d = out[int(q)]
                d[doc] = d.get(doc, 0) + n
    return out
