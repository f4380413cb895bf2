"""Backend registry — pluggable MapReduce engines behind one protocol.

Counterpart of ``repro/core/registry.py``. ``"1s"`` (the decoupled
engine, ``core/onesided.py``) and ``"2s"`` (the bulk-synchronous
baseline, ``core/twosided.py``) register on first resolution. Each
backend also hands out its segmented triple as :class:`ProgramHandle`\\ s
(``trace_handles``), the programs fleetlint's program rules run.
"""
from __future__ import annotations

import importlib
from collections.abc import Callable, Generator
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

    def trace_handles(self, spec: JobSpec, map_fn: MapFn, device,
                      segments: Callable[[int], list], tag: str = ""):
        """The segmented triple as :class:`ProgramHandle`\\ s for
        fleetlint (``repro_torch.analysis``), fed ``segments(seed)``."""
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


# ---------------------------------------------------------------------------
# runnable program handles (consumed by repro_torch.analysis — fleetlint)
# ---------------------------------------------------------------------------

# The engines' replication contract, by flattened argument/output path:
# the rows the engine design asserts equal on every rank (psum-maintained
# progress rows, carried owner maps). fleetlint's REP001 holds each one
# along the rank dim after every program call. ``carry.job_work`` is the
# cross-job executed-work row (one slot per co-scheduled member job),
# psum-maintained like ``carry.work``.
ENGINE_REPLICATED_CARRY = ("carry.status", "carry.cursor", "carry.work",
                           "carry.stolen", "carry.job_work",
                           "carry.owner_map", "carry.owner_split")

# a program's run: yields ``(fn, args)`` for each call, is sent each
# call's result
ProgramRun = Generator[tuple[Callable, tuple], object, None]


@dataclass(frozen=True)
class ProgramHandle:
    """One SPMD program of the port, runnable on seeded inputs.

    The reference's handle is traced, never run; this one runs. ``run(
    seed)`` makes the program's inputs from ``seed`` on the device the
    handle was built for, yields ``(fn, args)`` for each program call and
    is sent back ``fn(*args)``; what it runs between yields (an init, the
    segments before a finish) is set-up, not checked. ``arg_paths`` /
    ``out_paths`` name the tensor leaves of ``args`` and of the result, in
    order (:func:`leaves`); ``replicated_in`` / ``replicated_out`` are the
    subset asserted equal along the rank dim (dim 0, of size ``n_procs``),
    and ``seeded`` the inputs ``run`` makes itself (the rest come from
    earlier calls). ``allowed_axes`` is the reference's: the port's one
    axis is the rank dim. ``steps`` counts the engine steps one run takes,
    its set-up included."""
    name: str
    n_procs: int
    run: Callable[[int], ProgramRun]
    arg_paths: tuple[str, ...]
    out_paths: tuple[str, ...]
    replicated_in: tuple[str, ...] = ()
    replicated_out: tuple[str, ...] = ()
    seeded: tuple[str, ...] = ()
    allowed_axes: tuple[str, ...] = ("procs",)
    steps: int = 0


def leaves(x) -> list:
    """The tensor leaves of a program's arguments or result, in order: a
    tuple's (``EngineCarry``, ``Segment``) by field, host arrays (a
    ``Segment``'s grids) skipped."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def segment_program_handles(backend: Backend, spec: JobSpec, map_fn: MapFn,
                            device, segments: Callable[[int], list],
                            tag: str = "") -> tuple[ProgramHandle, ...]:
    """:class:`ProgramHandle`\\ s for a backend's segmented triple on
    ``device``: init; the feed ``Segment``\\ s ``segments(seed)`` makes,
    from init's carry (each one call); finish on the carry they leave.
    Each run makes a fresh engine (``backend.make_segment_fns``) and its
    segments anew. A segment's ``r = spec.code_rate`` columns (a code
    group's copies of one task) are one engine step."""
    from repro_torch.core.windows import EngineCarry

    carry_paths = tuple(f"carry.{f}" for f in EngineCarry._fields)
    seg_paths = ("tokens", "task_ids", "repeats")
    if not tag:
        fn_name = getattr(map_fn, "__name__", "map_fn")
        tag = f"{backend.name}/{fn_name}"
    steps = sum(seg.tokens.shape[1] for seg in segments(0)) \
        // spec.code_rate

    def runner(kind: str):
        def run(seed: int) -> ProgramRun:
            segs = segments(seed)
            init, segment, finish = backend.make_segment_fns(
                spec, map_fn, device)
            if kind == "init":
                yield init, ()
                return
            carry = init()
            for seg in segs:
                if kind == "segment":
                    carry = yield segment, (carry, seg)
                else:
                    carry = segment(carry, seg)
            if kind == "finish":
                yield finish, (carry,)
        return run

    P = spec.n_procs
    return (
        ProgramHandle(
            name=f"{tag}/init", n_procs=P, run=runner("init"),
            arg_paths=(), out_paths=carry_paths,
            replicated_out=ENGINE_REPLICATED_CARRY),
        ProgramHandle(
            name=f"{tag}/segment", n_procs=P, run=runner("segment"),
            arg_paths=carry_paths + seg_paths, out_paths=carry_paths,
            replicated_in=ENGINE_REPLICATED_CARRY,
            replicated_out=ENGINE_REPLICATED_CARRY, seeded=seg_paths,
            steps=steps),
        ProgramHandle(
            name=f"{tag}/finish", n_procs=P, run=runner("finish"),
            arg_paths=carry_paths,
            out_paths=("keys", "values", "combine_overflow"),
            replicated_in=ENGINE_REPLICATED_CARRY,
            replicated_out=("combine_overflow",), steps=steps),
    )
