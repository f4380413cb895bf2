"""The job lifecycle: ``submit(config, dataset) -> JobHandle``.

Counterpart of ``repro/core/job.py``, with ``device=`` in place of the
reference's ``mesh=``::

    cfg = JobConfig(usecase=WordCount(vocab=65_536), backend="1s",
                    task_size=4_096, push_cap=1_024, n_procs=8)
    result = submit(cfg, tokens).result()          # oneshot, on cuda

    cfg = dataclasses.replace(cfg, segment=2)      # streaming / ckpt mode
    handle = submit(cfg, MmapTokenSource("corpus.bin"), device="cpu")
    while handle.step():                           # one segment at a time
        handle.checkpoint(manager)                 # async window snapshot
    result = handle.result()

``backend`` is ``"1s"`` (the decoupled engine) or ``"2s"`` (the
bulk-synchronous baseline); both run through the same handle, feed and
result. A :class:`~repro_torch.data.feed.SegmentFeed` reads each segment
in a background thread and starts its device copy while the engine
computes the previous one; oneshot mode is one segment spanning the
input.

A checkpoint snapshot carries the feed's cursor and task assignment, so
``restore`` *seeks* the stream (no read is replayed), and a straggler
re-plan (``repro_torch.ft.straggler.replan_handle``) re-routes exactly
the not-yet-read tasks through the same feed. ``restore`` and ``load``
copy the snapshot into the carry's own buffers, which the fused step's
CUDA graphs replay into.

Many handles time-slice one device at segment granularity through
``repro_torch.core.scheduler.JobScheduler``: ``step()`` yields after a
segment, ``ready()`` says whether the next one's input has landed, and
``submit(..., feed_budget=)`` shares one prefetch budget among the
fleet's feeds.

``stealing=True`` rebalances work inside each 1S segment
(``core/steal.py``); ``partitioner="sampled"`` or ``"sampled+split"``
builds the owner map from a pre-pass over a few sampled tasks, at the
first step or checkpoint, into the same carry buffers. ``code_rate=r``
runs each task on the r ranks of its code group and pushes through the
XOR-coded exchange (``core/coded.py``); the feed then hands out r-wide
column blocks. ``JobScheduler(coschedule=True)`` merges compatible
handles into a ``core/workdomain.WorkDomain``, whose results its members
adopt (``adopt_result``). ``elastic_load`` resumes a snapshot taken at
another rank count, folded by ``repro_torch.fleet.remesh``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import coded, planner
from repro_torch.core.kv import KEY_SENTINEL
from repro_torch.core.partition import (Partitioner, resolve_partitioner,
                                        sample_key_histogram)
from repro_torch.core.registry import Backend, JobSpec, get_backend
from repro_torch.core.usecase import UseCase, as_map_fn, finalize
from repro_torch.core.windows import DenseWindow
from repro_torch.data.feed import SegmentFeed
from repro_torch.data.source import as_source
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class JobConfig:
    """Declarative job description; the reference's fields and defaults."""
    usecase: UseCase
    backend: str = "1s"
    task_size: int = 4096
    push_cap: int = 1024
    n_procs: int = 8
    segment: int = 0          # 0 -> oneshot; >0 -> tasks per step()
    window: int = 0           # 0 -> usecase.window
    combine_capacity: int = 0
    stealing: bool = False    # work stealing inside the 1S segment
                              #   (core/steal.py)
    partitioner: str | Partitioner = "hash"
                              # "hash", "sampled", "sampled+split" or a
                              #   Partitioner (core/partition.py)
    fused_map: bool = False   # per-step hot path as the fused_map CUDA
                              #   kernel — identical results
    code_rate: int = 1        # coded shuffle (core/coded.py): every map
                              #   task runs on r consecutive ranks and
                              #   the intra-group push is one XOR-coded
                              #   block; n_procs divisible by r, "1s"
                              #   unfused only


@dataclass(frozen=True)
class JobResult:
    """Structured outcome of a job."""
    records: dict[int, int]   # engine output: {key: reduced value}
    output: Any               # usecase.finalize(records)
    keys: np.ndarray          # rank-0 sorted keys (sentinel padded)
    values: np.ndarray
    wall_time: float          # seconds spent executing
    backend: str
    n_tasks: int
    tasks_per_rank: np.ndarray   # real (non-padding) tasks assigned per rank
    work_per_rank: np.ndarray    # compute-repeats executed per rank
    steals_per_rank: np.ndarray  # tasks each rank executed for a peer
    partitioner: str = "hash"
    n_split_keys: int = 0        # keys spread over >1 owner
    combine_overflow: int = 0    # records lost to an undersized
                                 #   combine_capacity (result() raises)

    @property
    def n_steals(self) -> int:
        return int(self.steals_per_rank.sum())

    @property
    def imbalance(self) -> float:
        """max/mean of per-rank work — 1.0 means perfectly balanced."""
        mean = self.work_per_rank.mean()
        return float(self.work_per_rank.max() / mean) if mean else 1.0


class CombineOverflowError(RuntimeError):
    """The Combine phase lost records to an undersized
    ``combine_capacity``; the partial result rides on ``err.result``."""

    def __init__(self, result: JobResult):
        self.result = result
        super().__init__(
            f"Combine overflow: {result.combine_overflow} record(s) were "
            f"dropped because combine_capacity is smaller than the number "
            f"of distinct keys — the returned counts would be wrong. "
            f"Raise JobConfig(combine_capacity=...) (>= distinct keys; "
            f"0 uses the full window, which never overflows). The partial "
            f"result is attached as err.result.")


def submit(config: JobConfig, dataset, *, device=None, repeats=None,
           prefetch: bool = True, feed_budget=None) -> JobHandle:
    """Plan ``dataset`` (a DataSource, or a 1-D int32 array) onto
    ``config.n_procs`` ranks on ``device`` (cuda unless given) and return
    a handle. Nothing executes until ``step()`` or ``result()``.

    ``repeats`` is the optional (n_procs, tasks_per_proc) compute-repeat
    grid (the paper's footnote-5 imbalance model). ``prefetch=False``
    disables the background read; ``feed_budget`` is a shared
    :class:`~repro_torch.data.feed.FeedBudget` that the feed reserves
    each background read from (``JobScheduler`` passes its own)."""
    backend = get_backend(config.backend)      # fail fast on bad names
    if config.stealing and not getattr(backend, "supports_stealing", False):
        raise ValueError(
            f"backend {config.backend!r} does not implement work stealing "
            "(no supports_stealing attribute) — drop stealing=True or use "
            "backend '1s'")
    if config.fused_map and not getattr(backend, "supports_fused_map",
                                        False):
        raise ValueError(
            f"backend {config.backend!r} does not implement the fused "
            "map hot path — drop fused_map=True or use backend '1s'")
    if config.code_rate > 1 and not getattr(backend, "supports_coded",
                                            False):
        raise ValueError(
            f"backend {config.backend!r} does not implement the coded "
            "exchange (no supports_coded attribute) — drop code_rate or "
            "use backend '1s'")
    partitioner = resolve_partitioner(config.partitioner)
    device = resolve_device(device)
    window = config.window or config.usecase.window
    spec = JobSpec(vocab=window, task_size=config.task_size,
                   push_cap=config.push_cap, n_procs=config.n_procs,
                   combine_capacity=config.combine_capacity,
                   segment=config.segment, stealing=config.stealing,
                   fused_map=config.fused_map, code_rate=config.code_rate,
                   partitioner=partitioner.name)
    source = as_source(dataset)
    plan = planner.plan_input(source.len_elements(), config.task_size,
                              config.n_procs)
    task_ids = planner.shard_task_ids(plan)
    T = plan.tasks_per_proc
    if repeats is None:
        repeats = np.ones((config.n_procs, T), np.int32)
    repeats = np.asarray(repeats, np.int32).reshape(config.n_procs, T)
    seg_tasks = config.segment if config.segment > 0 else max(T, 1)
    if config.code_rate > 1:
        # every member of a code group carries the group's tasks as
        # r-wide column blocks; a segment of N blocks is N*r columns
        task_ids, repeats = coded.replicate_grids(task_ids, repeats,
                                                  config.code_rate)
        seg_tasks *= config.code_rate
    feed = SegmentFeed(source, plan, task_ids, repeats, segment=seg_tasks,
                       device=device, prefetch=prefetch, budget=feed_budget)
    return JobHandle(config, backend, spec, device, plan, feed, partitioner)


class JobHandle:
    """Streaming lifecycle of one submitted job: ``step()`` advances one
    segment (segmented mode), ``result()`` runs to completion."""

    def __init__(self, config, backend: Backend, spec, device, plan,
                 feed: SegmentFeed, partitioner: Partitioner):
        self.config = config
        self.backend = backend
        self.spec = spec
        self.device = device
        self.plan = plan
        self.feed = feed
        self.partitioner = partitioner
        self._map_fn = as_map_fn(config.usecase)
        self._seg_fns = None
        self._carry = None
        self._owner_ready = False   # sampled owner map installed (or a
                                    #   snapshot's map adopted)
        self._wall = 0.0
        self._result: JobResult | None = None

    # -- resource lifecycle -------------------------------------------------

    def close(self):
        """Stop the feed's prefetch thread. Idempotent."""
        self.feed.close()

    def __enter__(self) -> JobHandle:
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- introspection ------------------------------------------------------

    @property
    def cursor(self) -> int:
        """Per-rank task slots completed so far (segmented mode)."""
        return self.feed.cursor

    @property
    def done(self) -> bool:
        return self._result is not None

    def ready(self) -> bool:
        """True when the next ``step()`` would not block on input I/O: the
        feed's background read of the upcoming segment has landed (or the
        stream is exhausted, or the job is done). With ``step()``, which
        yields at segment boundaries, the cooperative half of the
        scheduler's contract: it polls many jobs' feeds without blocking
        on any of them."""
        return self._result is not None or self.feed.ready()

    @property
    def carry(self):
        """The current EngineCarry (segmented mode)."""
        return self._carry

    @property
    def engine(self):
        """The backend's segment functions, made (with the carry) on first
        use: the ``"1s"`` engine's :class:`~repro_torch.core.onesided.
        SegmentFns`, the ``"2s"`` engine's triple."""
        self._ensure_engine()
        return self._seg_fns

    def windows(self) -> np.ndarray:
        """Per-rank dense Key-Value windows, host-side (P, window), with
        the in-flight ``pending_*`` chunk folded in."""
        assert self._carry is not None, "no carry yet — call step() first"
        P = self.spec.n_procs
        win = DenseWindow(self._carry.table.clone())
        win.put(self._carry.pending_k.reshape(P, -1),
                self._carry.pending_v.reshape(P, -1))
        return win.table.cpu().numpy()

    def remaining_task_ids(self) -> np.ndarray:
        """Global ids of tasks not yet executed (segmented mode) — what a
        straggler-aware re-plan redistributes."""
        return self.feed.remaining_task_ids()

    # -- segmented execution ------------------------------------------------

    def _ensure_engine(self):
        if self._seg_fns is None:
            self._seg_fns = self.backend.make_segment_fns(
                self.spec, self._map_fn, self.device)
            init_fn, _, _ = self._seg_fns
            self._carry = init_fn()

    def _ensure_owner_map(self):
        """Install the partitioner's owner map in the carry's buffers (a
        pre-pass through the feed, so the sample's reads land in
        ``feed.stats``), which the step graphs read. Deferred to the first
        advance or checkpoint, so that a ``restore``, which adopts the
        snapshot's map, never pays for a sample; the pre-pass counts into
        ``wall_time``."""
        if self._owner_ready:
            return
        if self.partitioner.needs_sample:   # else the carry's seed map
            t0 = time.perf_counter()
            self._install_partitioner()
            self._wall += time.perf_counter() - t0
        self._owner_ready = True

    def _install_partitioner(self):
        # the histogram has the engine's window (a JobConfig(window=) may
        # widen it past usecase.window), the carry's shape
        hist = sample_key_histogram(
            self.feed.sample_tasks, self.plan, self.config.usecase,
            getattr(self.partitioner, "sample_tasks", 16),
            window=self.spec.vocab)
        omap, osplit = self.partitioner.build(hist, self.spec.n_procs)
        for dst, row in ((self._carry.owner_map, omap),
                         (self._carry.owner_split, osplit)):
            dst.copy_(torch.from_numpy(np.asarray(row, np.int32))
                      .expand_as(dst))

    def _ensure_segmented(self):
        if self.config.segment <= 0:
            raise RuntimeError(
                "step()/checkpoint() need a segmented job — set "
                "JobConfig(segment=N) with N tasks per step")
        self._ensure_engine()

    def _install(self, carry):
        """Copy ``carry`` (tensors or host arrays) into the live carry's
        buffers: the fused step's CUDA graphs replay into those, so a
        carry that only replaced ``_carry`` would be ignored by them."""
        for dst, src in zip(self._carry, carry, strict=True):
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.ascontiguousarray(src, np.int32))
            dst.copy_(src)
        self._owner_ready = True        # the snapshot's map is the map
        if self.spec.stealing:
            self._seg_fns.host_work = None  # read the new work row back

    def _advance(self, n_segments: int) -> bool:
        self._ensure_owner_map()
        _, seg_fn, _ = self._seg_fns
        t0 = time.perf_counter()
        for _ in range(n_segments):
            seg = self.feed.next_segment()
            if seg is None:
                break
            self._carry = seg_fn(self._carry, seg)
        self._wall += time.perf_counter() - t0
        return not self.feed.exhausted

    def step(self, n_segments: int = 1) -> bool:
        """Advance up to ``n_segments`` segments. Returns True while map
        work remains."""
        if self._result is not None:
            return False
        self._ensure_segmented()
        return self._advance(n_segments)

    def replan(self, task_id_grid) -> JobHandle:
        """Install a re-planned (P, W) assignment of the *unread* tasks
        (from ``repro_torch.ft.straggler``); each task keeps its
        compute-repeat factor, so results stay exact by construction."""
        self._ensure_segmented()
        if self.spec.code_rate > 1:
            raise ValueError(
                "replan() does not support coded jobs (code_rate > 1): "
                "the r-replicated grid intentionally repeats every task "
                "r times, which the feed's exactly-once coverage "
                "contract rejects; resubmit the job instead")
        grid = np.asarray(task_id_grid, np.int32)
        by_task = {int(t): int(r) for t, r in
                   zip(self.feed.task_ids_grid.ravel(),
                       self.feed.repeats_grid.ravel()) if t >= 0}
        reps = np.ones_like(grid)
        for idx in zip(*np.nonzero(grid >= 0)):
            # unknown ids fall through to the feed's coverage check,
            # which names the offending tasks
            reps[idx] = by_task.get(int(grid[idx]), 1)
        self.feed.replan(grid, reps)
        return self

    def checkpoint(self, manager, **extra):
        """Snapshot the window carry into ``manager`` (a
        :class:`repro_torch.ckpt.CheckpointManager`) asynchronously: the
        carry is copied before this returns, and its transfer and write
        overlap the next segment. The manifest holds the reference's
        keys: the feed's position and task assignment, so that restore
        can seek, and what restore's guards check."""
        self._ensure_segmented()
        self._ensure_owner_map()    # a snapshot before the first step
                                    #   holds the sampled map, not the seed
        # reserved keys win over caller extras: restore() trusts them
        return manager.save_async(
            self.cursor, self._carry,
            extra={**extra,
                   "cursor": self.cursor,
                   "backend": self.backend.name,
                   "stealing": self.config.stealing,
                   "coslots": self.spec.coslots,
                   # provenance only: the fused and unfused paths give
                   # the same carries, so snapshots cross the flag
                   "fused_map": self.spec.fused_map,
                   # the grids are r-replicated column blocks for a
                   #   coded job: meaningless under another r
                   "code_rate": self.spec.code_rate,
                   "partitioner": self.spec.partitioner,
                   # lists in the manifest, made in the manager's worker
                   "task_ids": self.feed.task_ids_grid.copy(),
                   "repeats": self.feed.repeats_grid.copy()})

    def restore(self, manager, step: int | None = None) -> JobHandle:
        """Resume from a snapshot taken by :meth:`checkpoint`, by this
        package or the reference (possibly in another process): install
        the carry, then *seek* the feed to the saved cursor and
        assignment — no segment read is replayed.

        Raises ``ValueError`` if the snapshot was taken by another
        backend, or with another ``stealing``, ``coslots``,
        ``code_rate`` or ``partitioner``."""
        self._ensure_segmented()
        found, extra = manager.peek(step)
        mine = {"backend": self.backend.name,
                "stealing": self.config.stealing,
                "coslots": self.spec.coslots,
                "code_rate": self.spec.code_rate,
                "partitioner": self.spec.partitioner}
        for key, want in mine.items():
            saved = extra.get(key)
            if saved is not None and saved != want:
                raise ValueError(
                    f"checkpoint step {found} was taken with {key}="
                    f"{saved!r} — it cannot restore into a handle with "
                    f"{key}={want!r}; resubmit with the snapshot's {key}")
        # load exactly the snapshot the guard inspected (a concurrent
        # async save could otherwise re-resolve "latest" to a newer step)
        _, carry, extra = manager.restore(self._carry, step=found)
        self._install(carry)
        self.feed.seek(int(extra["cursor"]),
                       task_ids=extra.get("task_ids"),
                       repeats=extra.get("repeats"))
        return self

    def load(self, carry, cursor: int) -> JobHandle:
        """Install an in-memory carry snapshot (tensors or host arrays in
        the carry's layout) and seek the feed to ``cursor``."""
        self._ensure_segmented()
        self._install(carry)
        self.feed.seek(int(cursor))
        return self

    def elastic_load(self, table, owner_map, owner_split, task_ids,
                     repeats) -> JobHandle:
        """Resume a job that ran at a *different* rank count: install
        windows and owner rows already folded onto this handle's ranks
        (``repro_torch.fleet.remesh``), and the re-bucketized assignment
        of the not-yet-executed tasks, then seek the feed to column 0 of
        that grid.

        The saved carry cannot be installed whole: every rank-shaped
        leaf (``pending_*``, ``work``, ``stolen``, ``job_work``) has the
        wrong P. They keep this carry's values: the caller folded the
        pending chunks into ``table``, the steal progress row only seeds
        future claims, and the cursor is bookkeeping. The three leaves
        are copied into the live carry's buffers, which the fused step's
        CUDA graphs replay into. Exactness rests on the Combine dup-sum:
        the folded windows hold every executed record, wherever they now
        live."""
        self._ensure_segmented()
        if self.spec.code_rate > 1:
            raise ValueError(
                "elastic_load() does not support coded jobs (code_rate > "
                "1): the r-replicated grid repeats every task r times, "
                "which a re-bucketized grid cannot hold; resubmit the job "
                "instead")
        P, vocab = self.spec.n_procs, self.spec.vocab
        if tuple(table.shape) != (P, vocab):
            raise ValueError(
                f"elastic_load: folded windows have shape "
                f"{tuple(table.shape)}, this handle runs (n_procs, window) "
                f"= {(P, vocab)} — fold onto the NEW mesh before loading")

        def rows(m):
            m = torch.as_tensor(np.asarray(m, np.int32)
                                if not isinstance(m, torch.Tensor) else m)
            if m.dim() == 1:            # replicated row -> per-rank copies
                m = m.expand(P, -1)
            assert tuple(m.shape) == (P, vocab), tuple(m.shape)
            return m

        for dst, src in ((self._carry.table, table),
                         (self._carry.owner_map, owner_map),
                         (self._carry.owner_split, owner_split)):
            dst.copy_(rows(src))
        self._owner_ready = True        # the folded map IS the map
        if self.spec.stealing:
            self._seg_fns.host_work = None  # read the fresh work row back
        self.feed.seek(0, task_ids=task_ids, repeats=repeats)
        return self

    # -- completion ---------------------------------------------------------

    def adopt_result(self, result: JobResult) -> JobHandle:
        """Install a result computed for this job by a
        :class:`~repro_torch.core.workdomain.WorkDomain`: the member never
        built an engine, its tasks ran in the domain's composite run, and
        the records are its solo run's. The feed stops; ``result()``
        serves the adopted outcome, overflow check included."""
        assert self._result is None, "job already has a result"
        self._result = result
        self.feed.close()
        return self

    def result(self) -> JobResult:
        """Run to completion and return the JobResult. Raises
        :class:`CombineOverflowError` when the Combine phase lost
        records. The feed's thread is stopped on every exit path."""
        if self._result is None:
            try:
                self._result = self._finish()
            finally:
                self.feed.close()
        if self._result.combine_overflow:
            raise CombineOverflowError(self._result)
        return self._result

    def _finish(self) -> JobResult:
        self._ensure_engine()
        while self._advance(1):
            pass
        _, _, fin_fn = self._seg_fns
        t0 = time.perf_counter()
        keys, vals, overflow = fin_fn(self._carry)
        keys = keys[0].cpu().numpy()
        vals = vals[0].cpu().numpy()
        overflow = int(overflow[0])                # replicated
        self._wall += time.perf_counter() - t0
        valid = keys != KEY_SENTINEL
        records = dict(zip(keys[valid].tolist(), vals[valid].tolist()))
        ids, reps = self.feed.task_ids_grid, self.feed.repeats_grid
        task_valid = ids >= 0
        if self.config.stealing:
            # the executed distribution, from the carry's progress rows
            work = self._carry.work[0].cpu().numpy()
            steals = self._carry.stolen[0].cpu().numpy()
        else:
            work = (reps * task_valid).sum(axis=1)
            steals = np.zeros((self.config.n_procs,), np.int32)
        return JobResult(
            records=records,
            output=finalize(self.config.usecase, records),
            keys=keys, values=vals,
            wall_time=self._wall,
            backend=self.backend.name,
            n_tasks=self.plan.n_tasks,
            tasks_per_rank=task_valid.sum(axis=1),
            work_per_rank=work,
            steals_per_rank=steals,
            partitioner=self.spec.partitioner,
            n_split_keys=int((self._carry.owner_split[0] > 1).sum()),
            combine_overflow=overflow,
        )
