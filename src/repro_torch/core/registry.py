"""Backend registry — pluggable MapReduce engines behind one protocol.

Counterpart of ``repro/core/registry.py``. ``"1s"`` (the decoupled
engine, ``core/onesided.py``) and ``"2s"`` (the bulk-synchronous
baseline, ``core/twosided.py``) register on first resolution.
"""
from __future__ import annotations

import importlib
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Protocol, runtime_checkable

_BUILTIN_MODULES = {"1s": "repro_torch.core.onesided",
                    "2s": "repro_torch.core.twosided"}
_REGISTRY: dict[str, type] = {}
_INSTANCES: dict[str, Backend] = {}


@dataclass(frozen=True)
class JobSpec:
    """Static engine settings (paper: Init(filename, win_size, chunk_size,
    task_size, ...)); the reference's fields that this port honors."""
    vocab: int                   # dense Key-Value window size ("win_size")
    task_size: int               # elements per Map task
    push_cap: int                # records per one-sided push per owner
    n_procs: int
    combine_capacity: int = 0    # 0 -> vocab
    segment: int = 0             # tasks per segment (0 -> oneshot)
    stealing: bool = False       # work stealing inside the 1S segment
                                 #   (core/steal.py)
    fused_map: bool = False      # per-step hot path as the fused_map
                                 #   kernel; identical results
    code_rate: int = 1           # r-replicated coded shuffle
                                 #   (core/coded.py, collectives.
                                 #   coded_exchange); a comparing field, so
                                 #   coded and uncoded jobs never share a
                                 #   program
    # cross-job co-scheduling (core/workdomain.py): ``coslots`` member
    # jobs in one engine run (1: a solo job), composite task id
    # ``slot * costride + local_id``, composite key ``slot * (vocab //
    # coslots) + key``
    coslots: int = 1
    costride: int = 0
    partitioner: str = field(default="hash", compare=False)

    def __post_init__(self):
        if not self.combine_capacity:
            object.__setattr__(self, "combine_capacity", self.vocab)
        if self.code_rate < 1:
            raise ValueError(f"code_rate must be >= 1, got {self.code_rate}")
        if self.code_rate > 1:
            if self.n_procs % self.code_rate:
                raise ValueError(
                    f"code_rate={self.code_rate} needs n_procs divisible "
                    f"into r-rank code groups (got n_procs={self.n_procs})")
            if self.fused_map:
                raise ValueError(
                    "fused_map does not compose with the coded exchange "
                    "(code_rate > 1) — the fused kernel pushes per-task "
                    "unicast buckets; run coded jobs unfused")
            if self.coslots > 1:
                raise ValueError(
                    "co-scheduling (coslots > 1) does not compose with "
                    "code_rate > 1 — the fleet cursor claims single task "
                    "slots, which would break the r-group decode")
        if self.coslots > 1:
            if self.fused_map:
                raise ValueError(
                    "fused_map does not compose with co-scheduling "
                    "(coslots > 1) — the WorkDomain falls back to solo "
                    "slicing for fused jobs instead")
            if self.costride <= 0:
                raise ValueError("coslots > 1 needs a positive costride")
            if self.vocab % self.coslots:
                raise ValueError(
                    f"co-scheduled vocab {self.vocab} must be "
                    f"coslots={self.coslots} equal per-job windows")


# map_fn(tokens (P, S), task_id (P,), repeat (P,), max_rep) -> (keys, values)
MapFn = Callable


@runtime_checkable
class Backend(Protocol):
    """What every engine provides, with ``device`` in place of the
    reference's mesh."""

    name: str

    def run_job(self, spec: JobSpec, map_fn: MapFn, device, tokens,
                task_ids, repeats) -> tuple:
        """Blocking end-to-end run over host arrays tokens (P, T, S) and
        task_ids/repeats (P, T). Returns rank-0 (keys, values)."""
        ...

    def make_segment_fns(self, spec: JobSpec, map_fn: MapFn, device):
        """``(init_fn, segment_fn, finish_fn)`` sharing the
        :class:`~repro_torch.core.windows.EngineCarry` carry;
        ``segment_fn(carry, seg)`` advances one feed ``Segment``."""
        ...


class UnknownBackendError(KeyError):
    pass


def register_backend(name: str):
    """Class decorator: ``@register_backend("1s")`` makes the engine
    resolvable by name through :func:`get_backend`."""
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def get_backend(name: str) -> Backend:
    """Resolve a backend name to its (singleton) engine instance."""
    if name not in _REGISTRY and name in _BUILTIN_MODULES:
        importlib.import_module(_BUILTIN_MODULES[name])
    if name not in _REGISTRY:
        raise UnknownBackendError(
            f"unknown backend {name!r}; available: {available_backends()}")
    if name not in _INSTANCES:
        _INSTANCES[name] = _REGISTRY[name]()
    return _INSTANCES[name]


def available_backends():
    for name, module in _BUILTIN_MODULES.items():
        if name not in _REGISTRY:
            importlib.import_module(module)
    return sorted(_REGISTRY)
