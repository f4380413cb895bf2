"""SegmentFeed — the paper's non-blocking I/O, feeding the engine.

Counterpart of ``repro/data/feed.py``. "Each process asynchronously
retrieves the input for the next Map task while computing the current
one" (§2.1): a background thread reads segment t+1's tasks by
``plan.file_offset`` and starts its host→device copy while the device
runs segment t.

On a CUDA device the thread reads each segment into one of **two pinned
host buffers** and copies it with ``non_blocking=True`` on a side stream,
recording an event. The consumer makes its own stream wait on that event
and marks the device tensor with ``record_stream``, so the allocator
cannot hand the memory out again while the consumer's stream still reads
it. A pinned buffer is refilled only after the event of its previous
copy has completed — a copy still in flight would otherwise read the
next segment's bytes. On ``device="cpu"`` there is no pinning and no
stream: segments are host tensors. The pinned pair and the side stream
are made at the feed's first build on the card and given back at
``close``, so a feed that never builds (a job the scheduler keeps
queued) pins nothing, and a finished job's feed holds nothing.

Segments are padded to the fixed ``segment`` column width with no-op
tasks (id -1, all-sentinel tokens, repeat 1). The feed owns the job's
assignment grids and column cursor, which makes it the seam for
checkpoint restore (``seek``: reposition without replaying a read) and
straggler re-planning (``replan``: swap the unread columns). Each
prefetch is tagged with the generation of the plan it read; a seek or
replan starts a new generation, so a prefetch of the old plan, even one
still in flight on the feed's thread and stream, is dropped. Peak host
residency is O(segment).

With many jobs live at once (``repro_torch.core.scheduler.JobScheduler``)
many feeds prefetch concurrently; a shared :class:`FeedBudget` bounds
their combined in-flight bytes, as the reference's does. A denied
reservation only skips the background read: the segment is built
synchronously when it is consumed, so the budget serializes a job's I/O
and never stalls it. The budget counts the segment's token bytes, not
the pinned pair.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


@dataclass
class FeedStats:
    """Observability counters (host side, not device memory)."""
    bytes_read: int = 0          # total bytes materialized from the source
    segments_built: int = 0
    prefetch_hits: int = 0       # segments served from the background read
    prefetch_misses: int = 0     # segments built synchronously
    max_live_bytes: int = 0      # high-water mark of feed-held host bytes
    build_seconds: float = 0.0   # host seconds spent reading and staging
                                 #   segments (the feed's thread included)
    sample_tasks_read: int = 0   # tasks read by a partitioner pre-pass
                                 #   (core/partition.py); their bytes are
                                 #   included in bytes_read
    budget_denials: int = 0      # prefetches skipped because the shared
                                 #   FeedBudget was exhausted (the segment
                                 #   was built synchronously instead)
    _live: dict = field(default_factory=dict, repr=False)

    def _track(self, key, nbytes: int):
        self._live[key] = nbytes
        self.max_live_bytes = max(self.max_live_bytes,
                                  sum(self._live.values()))

    def _release(self, key):
        self._live.pop(key, None)


class FeedBudget:
    """Shared in-flight-bytes arbiter across many live SegmentFeeds.

    One scheduler-owned instance is passed to every feed it creates
    (``submit(..., feed_budget=...)``); a feed reserves the estimated
    segment bytes before it schedules a *background* read. When the
    combined reservations would pass ``max_live_bytes`` the prefetch is
    denied (counted here and in the feed's ``stats.budget_denials``) and
    the segment is built synchronously when it is consumed.

    One reservation is always granted when nothing is held, so a single
    oversized segment degrades to serialized prefetch instead of
    disabling prefetch fleet-wide.
    """

    def __init__(self, max_live_bytes: int):
        if max_live_bytes <= 0:
            raise ValueError(f"budget must be positive bytes, got "
                             f"{max_live_bytes}")
        self.max_live_bytes = int(max_live_bytes)
        self._held: dict = {}
        self._lock = threading.Lock()
        self.denials = 0             # fleet-wide (per-feed copies in stats)

    @property
    def live_bytes(self) -> int:
        with self._lock:
            return sum(self._held.values())

    def try_reserve(self, key, nbytes: int) -> bool:
        with self._lock:
            if (self._held
                    and sum(self._held.values()) + nbytes
                    > self.max_live_bytes):
                self.denials += 1
                return False
            self._held[key] = int(nbytes)
            return True

    def release(self, key):
        with self._lock:
            self._held.pop(key, None)


class Segment(NamedTuple):
    """One segment on the feed's device, plus its grids on the host."""
    tokens: torch.Tensor      # (P, n, S) int32
    task_ids: torch.Tensor    # (P, n) int32
    repeats: torch.Tensor     # (P, n) int32
    ids: np.ndarray           # (P, n) ``task_ids`` on the host
    reps: np.ndarray          # (P, n) ``repeats`` on the host

    @property
    def max_rep(self) -> np.ndarray:
        """(n,) per-column max repeat, the host-side loop bound."""
        return self.reps.max(axis=0)

    @classmethod
    def of(cls, tokens, task_ids, repeats, device) -> Segment:
        """A segment of host arrays ``tokens (P, n, S)`` and
        ``task_ids``/``repeats (P, n)``, copied to ``device``."""
        ids = np.asarray(task_ids, np.int32)
        reps = np.asarray(repeats, np.int32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(device)

        return cls(dev(tokens), dev(ids), dev(reps), ids, reps)


class _Staged(NamedTuple):
    flat: torch.Tensor        # [tokens | task ids | repeats], flattened
    event: torch.cuda.Event | None
    ids: np.ndarray
    reps: np.ndarray


class SegmentFeed:
    """Pull-based segment stream over a DataSource for one job.

    ``next_segment()`` returns the next :class:`Segment` and schedules
    the following segment's read and copy in the background.
    """

    def __init__(self, source, plan, task_ids: np.ndarray,
                 repeats: np.ndarray, segment: int, *, device,
                 prefetch: bool = True, budget: FeedBudget | None = None):
        self.source = source
        self.plan = plan
        self.segment = int(segment)
        assert self.segment > 0, "segment width must be positive"
        self.device = torch.device(device)
        self._ids = np.array(task_ids, np.int32)       # (P, T)
        self._reps = np.array(repeats, np.int32)       # (P, T)
        self._cursor = 0                               # columns consumed
        self._prefetch = prefetch
        self._budget = budget
        self._budget_key = None                        # held reservation
        self._gen = 0                                  # seek/replan epoch
        # (start column, its read, the generation it read)
        self._pending: tuple[int, Future, int] | None = None
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="segment-feed")
        self._closed = False
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = FeedStats()
        # the card's staging: made at the first build, given back at close
        self._stage_lock = threading.Lock()
        self._pinned: list[torch.Tensor] | None = None
        self._copied: list[torch.cuda.Event | None] = [None, None]
        self._next_buf = 0
        self._stream: torch.cuda.Stream | None = None

    # -- assignment state ---------------------------------------------------

    @property
    def cursor(self) -> int:
        return self._cursor

    @property
    def total_columns(self) -> int:
        return self._ids.shape[1]

    @property
    def task_ids_grid(self) -> np.ndarray:
        """The full (P, T) assignment, consumed prefix included."""
        return self._ids

    @property
    def repeats_grid(self) -> np.ndarray:
        return self._reps

    @property
    def exhausted(self) -> bool:
        return self._cursor >= self.total_columns

    def remaining_task_ids(self) -> np.ndarray:
        """Global ids of the not-yet-consumed tasks, sorted."""
        ids = self._ids[:, self._cursor:]
        return np.sort(ids[ids >= 0])

    def consumed_task_ids(self) -> np.ndarray:
        """Global ids of the already-executed tasks (columns before the
        cursor), sorted."""
        ids = self._ids[:, : self._cursor]
        return np.sort(ids[ids >= 0])

    def read_tasks(self, task_ids) -> np.ndarray:
        """Serve arbitrary tasks by *global id* on the host, independent
        of the grids or cursor (reads are pure); the bytes count into
        ``stats``."""
        from repro_torch.core.planner import read_tasks  # lazy: no cycle
        tokens = read_tasks(self.source, self.plan, task_ids)
        with self._stats_lock:
            self.stats.bytes_read += tokens.nbytes
        return tokens

    def sample_tasks(self, task_ids) -> np.ndarray:
        """:meth:`read_tasks` for a partitioner's sampling pre-pass: the
        same read by global id, counted apart so that a job's stats show
        what the skew sample cost."""
        tokens = self.read_tasks(task_ids)
        with self._stats_lock:
            self.stats.sample_tasks_read += int(np.asarray(task_ids).size)
        return tokens

    # -- segment construction ----------------------------------------------

    def _stage_buffers(self):
        """Pin the double buffer and make the side stream (under
        ``_stage_lock``, at the first build on the card)."""
        n = self._ids.shape[0] * self.segment * (self.plan.task_size + 2)
        self._pinned = [torch.empty((n,), dtype=torch.int32,
                                    pin_memory=True) for _ in range(2)]
        self._copied = [None, None]
        self._next_buf = 0
        self._stream = torch.cuda.Stream(self.device)

    def _free_buffers(self):
        """Give the pinned pair and the stream back, once the copies out
        of the pair have landed."""
        with self._stage_lock:
            for event in self._copied:
                if event is not None:
                    event.synchronize()
            self._pinned, self._stream = None, None
            self._copied = [None, None]

    def _grids(self, start: int):
        end = min(start + self.segment, self.total_columns)
        P = self._ids.shape[0]
        ids = np.full((P, self.segment), -1, np.int32)
        reps = np.ones((P, self.segment), np.int32)
        ids[:, : end - start] = self._ids[:, start:end]
        reps[:, : end - start] = self._reps[:, start:end]
        return ids, reps

    def _build(self, start: int, gen: int) -> _Staged:
        """Read one segment's tasks by file offset and start its device
        copy — the body that runs in the feed thread."""
        from repro_torch.core.planner import gather_segment  # lazy: no cycle
        t0 = time.perf_counter()
        ids, reps = self._grids(start)
        n_tok = ids.size * self.plan.task_size
        if self.device.type != "cuda":
            tokens = gather_segment(self.source, self.plan, ids)
            flat = torch.from_numpy(np.concatenate(
                [tokens.reshape(-1), ids.reshape(-1), reps.reshape(-1)]))
            staged = _Staged(flat, None, ids, reps)
        else:
            with self._stage_lock:
                if self._pinned is None:
                    self._stage_buffers()
                b = self._next_buf
                self._next_buf ^= 1
                if self._copied[b] is not None:
                    # the copy out of this buffer two segments ago must
                    # have landed before the buffer is refilled
                    self._copied[b].synchronize()
                host = self._pinned[b].numpy()
                gather_segment(self.source, self.plan, ids,
                               out=host[:n_tok].reshape(ids.shape + (-1,)))
                host[n_tok: n_tok + ids.size] = ids.reshape(-1)
                host[n_tok + ids.size:] = reps.reshape(-1)
                with torch.cuda.stream(self._stream):
                    flat = self._pinned[b].to(self.device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._copied[b] = event
            staged = _Staged(flat, event, ids, reps)
        with self._stats_lock:
            self.stats.bytes_read += n_tok * 4
            self.stats.segments_built += 1
            self.stats.build_seconds += time.perf_counter() - t0
            if gen == self._gen:    # a stale prefetch is not tracked
                self.stats._track((gen, start), n_tok * 4)
        return staged

    def _schedule(self, start: int):
        if (self._closed or not self._prefetch
                or start >= self.total_columns):
            self._pending = None
            return
        gen = self._gen
        if self._budget is not None:
            # reserve the estimated segment bytes before the background
            # read; a denial is not an error: next_segment builds the
            # segment synchronously when it gets there
            est = (self._ids.shape[0] * self.segment
                   * self.plan.task_size * 4)
            key = (id(self), gen, start)
            if not self._budget.try_reserve(key, est):
                with self._stats_lock:
                    self.stats.budget_denials += 1
                self._pending = None
                return
            self._budget_key = key
        self._pending = (start, self._pool.submit(self._build, start, gen),
                         gen)

    def _drop_budget(self):
        if self._budget is not None and self._budget_key is not None:
            self._budget.release(self._budget_key)
            self._budget_key = None

    def _segment(self, staged: _Staged) -> Segment:
        flat = staged.flat
        if staged.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.event)
            flat.record_stream(stream)
        ids = staged.ids
        n_tok = ids.size * self.plan.task_size
        return Segment(
            tokens=flat[:n_tok].view(ids.shape + (self.plan.task_size,)),
            task_ids=flat[n_tok: n_tok + ids.size].view(ids.shape),
            repeats=flat[n_tok + ids.size:].view(ids.shape),
            ids=ids, reps=staged.reps)

    # -- the streaming contract --------------------------------------------

    def next_segment(self) -> Segment | None:
        """Return the next segment and kick off the background read of
        the one after; ``None`` when the stream is exhausted."""
        with self._lock:
            if self.exhausted:
                return None
            start, gen = self._cursor, self._gen
            p = self._pending
            if p is not None and (p[0], p[2]) == (start, gen):
                staged = p[1].result()
                self.stats.prefetch_hits += 1
            else:
                staged = self._build(start, gen)
                self.stats.prefetch_misses += 1
            with self._stats_lock:
                self.stats._release((gen, start))
            self._drop_budget()
            self._cursor = min(start + self.segment, self.total_columns)
            self._schedule(self._cursor)
            return self._segment(staged)

    def ready(self) -> bool:
        """True when :meth:`next_segment` would not block on input I/O."""
        with self._lock:
            if self.exhausted or self._closed:
                return True
            p = self._pending
            return (p is not None and (p[0], p[2]) == (self._cursor,
                                                       self._gen)
                    and p[1].done())

    def prime(self):
        """Start the background read of the segment at the cursor without
        consuming anything, so a freshly admitted job's first segment is
        read while other jobs run their slices. Idempotent; a no-op when a
        prefetch is pending or the shared budget denies the reservation."""
        with self._lock:
            if self._pending is None:
                self._schedule(self._cursor)

    def seek(self, cursor: int, task_ids=None, repeats=None):
        """Reposition the stream (checkpoint restore): install the saved
        assignment grids and cursor. No segment before ``cursor`` is
        re-read: restore seeks, it does not replay."""
        with self._lock:
            if task_ids is not None:
                self._ids = np.array(task_ids, np.int32)
            if repeats is not None:
                self._reps = np.array(repeats, np.int32)
            self._cursor = int(cursor)
            self._invalidate()
        return self

    def replan(self, task_ids: np.ndarray, repeats: np.ndarray):
        """Re-route the *unread* tasks (straggler mitigation): columns
        before the cursor keep their history; columns from the cursor on
        are replaced by the new (P, W) assignment, which must hold every
        unread task exactly once. A prefetch of the old assignment is
        dropped."""
        task_ids = np.asarray(task_ids, np.int32)
        repeats = np.asarray(repeats, np.int32)
        if task_ids.shape != repeats.shape:
            raise ValueError(f"task ids {task_ids.shape} and repeats "
                             f"{repeats.shape} differ in shape")
        if task_ids.ndim != 2 or task_ids.shape[0] != self._ids.shape[0]:
            raise ValueError(f"replan needs a ({self._ids.shape[0]}, W) "
                             f"grid, got {task_ids.shape}: the rank count "
                             "is fixed")
        with self._lock:
            old = self.remaining_task_ids().tolist()
            new = sorted(task_ids[task_ids >= 0].tolist())
            if new != old:
                raise ValueError(
                    "replan must cover exactly the unread tasks once "
                    f"(unread={old}, got={new})")
            self._ids = np.concatenate(
                [self._ids[:, : self._cursor], task_ids], axis=1)
            self._reps = np.concatenate(
                [self._reps[:, : self._cursor], repeats], axis=1)
            self._invalidate()
        return self

    def _invalidate(self):
        """Start a new generation: drop the pending prefetch (cancelled,
        or read and thrown away when its read has begun) and schedule
        the segment at the cursor."""
        with self._stats_lock:
            self._gen += 1
            self.stats._live.clear()
        if self._pending is not None:
            self._pending[1].cancel()
            self._pending = None
        self._drop_budget()
        self._schedule(self._cursor)

    def close(self):
        """Stop the prefetch thread, waiting for a read in progress so no
        copy outlives the feed, return the budget's reservation and give
        the pinned pair back. Idempotent; a closed feed can still be
        consumed (reads then run in the caller's thread)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._pending = None
                self._drop_budget()
                self._pool.shutdown(wait=True)
                self._free_buffers()
