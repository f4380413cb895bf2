"""Declarative use-case protocol, batched over the rank dim.

Counterpart of ``repro/core/usecase.py``. A use-case provides

  * ``window`` — the dense Key-Value window size it needs;
  * ``map_emit(tokens, task_id) -> (keys, values)`` — pure Map logic on
    ``tokens (P, S)`` and ``task_id (P,)`` (-1 for padding tasks),
    emitting ``(P, S')`` int32 records with keys in [0, window) and
    KEY_SENTINEL for empty slots;
  * ``local_reduce(keys, values)`` *(optional)* — a per-task combiner;
  * ``finalize(records)`` *(optional)* — decode ``{key: value}``.

:func:`as_map_fn` adapts one into the engines'
``map_fn(tokens, task_id, repeat, max_rep)``, attaching the paper's
footnote-5 imbalance model uniformly, one ``map_fn`` a use-case.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.kv import mix32


@runtime_checkable
class UseCase(Protocol):
    window: int

    def map_emit(self, tokens: torch.Tensor,
                 task_id: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        ...


def work_dependency(tokens: torch.Tensor, repeat: torch.Tensor,
                    max_rep: int) -> torch.Tensor:
    """``(P,)`` zeros carrying a data dependency on ``max(repeat[r], 1)``
    iterations of real per-token mixing work on each rank r (paper
    footnote 5): iteration i mixes ``tokens + i`` as uint32, exactly the
    reference's loop body. The iterations run as one batched pass over
    ``(max_rep, P, S)``; row r keeps the mixes of its own iterations."""
    n = max(int(max_rep), 1)
    it = torch.arange(n, device=tokens.device).view(n, 1, 1)
    mixed = mix32(tokens.to(torch.int64).unsqueeze(0) + it)
    live = it < repeat.clamp(min=1).view(1, -1, 1)
    acc = torch.where(live, mixed, 0).sum(dim=0)
    return (acc & 0).sum(dim=-1).to(torch.int32)


def _build_map_fn(usecase: UseCase):
    combiner = getattr(usecase, "local_reduce", None)

    def map_fn(tokens, task_id, repeat, max_rep: int):
        keys, vals = usecase.map_emit(tokens, task_id)
        vals = vals + work_dependency(tokens, repeat, max_rep).unsqueeze(-1)
        if combiner is not None:
            keys, vals = combiner(keys, vals)
        return keys, vals

    return map_fn


_MAP_FN_CACHE: dict = {}


def as_map_fn(usecase: UseCase):
    """Adapt a UseCase into the engines'
    ``map_fn(tokens, task_id, repeat, max_rep) -> (keys, values)``.

    Memoized per (hashable) use-case, as the reference's is: the handles
    of one use-case share one ``map_fn``, which is what the scheduler's
    program key ``(backend, spec, id(map_fn))`` counts."""
    try:
        fn = _MAP_FN_CACHE.get(usecase)
        if fn is None:
            _MAP_FN_CACHE[usecase] = fn = _build_map_fn(usecase)
        return fn
    except TypeError:                     # unhashable custom use-case
        return _build_map_fn(usecase)


def finalize(usecase, records: dict):
    fin = getattr(usecase, "finalize", None)
    return fin(records) if fin is not None else records
