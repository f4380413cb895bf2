"""Straggler mitigation: throughput-aware task re-planning.

A numpy copy of ``repro/ft/straggler.py``: the same functions, with the
same outputs for the same inputs. The host tracks per-rank segment
throughput and re-plans the **remaining** tasks proportionally at
segment boundaries. Re-planning (not re-issuing in-flight work) keeps
exactly-once semantics, so results stay exact.

With the Job API the integration point is a segmented ``JobHandle``:
call :func:`replan_handle` between ``handle.step()`` calls to
redistribute ``handle.remaining_task_ids()``, and seed the tracker from
a completed job's per-rank work with :func:`tracker_from_result`.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ThroughputTracker:
    n_procs: int
    alpha: float = 0.5                       # EWMA smoothing
    rate: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.rate is None:
            self.rate = np.ones((self.n_procs,), np.float64)

    def update(self, seg_seconds: np.ndarray):
        """seg_seconds: wall time each rank spent on the last segment
        (same task count each) — lower is faster."""
        seg_seconds = np.maximum(np.asarray(seg_seconds, np.float64), 1e-9)
        inst = 1.0 / seg_seconds
        self.rate = self.alpha * inst + (1 - self.alpha) * self.rate

    def is_straggler(self, threshold: float = 0.5) -> np.ndarray:
        """Ranks slower than ``threshold`` × median throughput."""
        med = np.median(self.rate)
        return self.rate < threshold * med

    def update_work(self, work_per_rank: np.ndarray, seconds: float):
        """EWMA update from the work each rank executed over one slice of
        equal wall time. A rank assigned nothing carries no signal and
        keeps its estimate (folding its zero in would starve it)."""
        work = np.asarray(work_per_rank, np.float64)
        inst = work / max(float(seconds), 1e-9)
        observed = work > 0
        self.rate = np.where(observed,
                             self.alpha * inst
                             + (1 - self.alpha) * self.rate,
                             self.rate)


def rebalance_tasks(task_ids: list[int], rate: np.ndarray,
                    tasks_per_segment: int) -> np.ndarray:
    """Assign the next segment's tasks proportional to throughput.

    Returns (n_procs, tasks_per_proc) of task ids, -1 padded (a -1 task is
    a no-op in the engine). Every task appears exactly once."""
    n_procs = len(rate)
    quota = rate / rate.sum() * min(len(task_ids), tasks_per_segment)
    counts = np.floor(quota).astype(int)
    # distribute the remainder to the fastest ranks
    rem = min(len(task_ids), tasks_per_segment) - counts.sum()
    order = np.argsort(-rate)
    for i in range(rem):
        counts[order[i % n_procs]] += 1
    width = max(counts.max(initial=1), 1)
    out = -np.ones((n_procs, width), np.int32)
    cursor = 0
    for r in range(n_procs):
        take = counts[r]
        out[r, :take] = task_ids[cursor: cursor + take]
        cursor += take
    return out


def tracker_from_result(result, alpha: float = 0.5) -> ThroughputTracker:
    """Seed a tracker from a completed job's per-rank work stats
    (``JobResult.work_per_rank``): ranks that carried more compute-repeats
    in the same wall time were proportionally faster."""
    work = np.asarray(result.work_per_rank, np.float64)
    tr = ThroughputTracker(n_procs=len(work), alpha=alpha)
    tr.rate = np.maximum(work, 1e-9) / max(result.wall_time, 1e-9)
    return tr


def plan_next_segment(handle, tracker: ThroughputTracker,
                      tasks_per_segment: int = 0) -> np.ndarray:
    """Re-plan a segmented ``JobHandle``'s remaining tasks proportional to
    tracked throughput: the (n_procs, width) task-id grid (-1 padded);
    every remaining task appears exactly once."""
    remaining = handle.remaining_task_ids()
    per_seg = tasks_per_segment or len(remaining)
    return rebalance_tasks(remaining.tolist(), tracker.rate, per_seg)


def replan_handle(handle, tracker: ThroughputTracker) -> np.ndarray:
    """Re-route the handle's *unread* tasks through its SegmentFeed,
    proportional to tracked throughput: the feed drops any prefetch of
    the old assignment and reads the new one. Each task keeps its
    compute-repeat factor. Returns the installed (n_procs, width) grid."""
    assignment = plan_next_segment(handle, tracker)
    handle.replan(assignment)
    return assignment


def outer_rebalance(handle, tracker: ThroughputTracker,
                    drift_threshold: float = 0.0):
    """Re-plan the handle's unread tasks only when the tracked drift
    (fastest/slowest rank ratio) reaches ``drift_threshold``; 0.0 picks
    2.0 for a stealing handle and 1.0 (always) otherwise. Returns the
    installed grid, or ``None`` when skipped."""
    if not drift_threshold:
        drift_threshold = 2.0 if handle.config.stealing else 1.0
    drift = float(tracker.rate.max() / max(tracker.rate.min(), 1e-9))
    if drift < drift_threshold:
        return None
    return replan_handle(handle, tracker)


def rebalance_hook(alpha: float = 0.5, drift_threshold: float = 0.0):
    """:func:`outer_rebalance` as a between-slices callback
    ``hook(handle, slice_stats)`` (``slice_stats.seconds`` and
    ``slice_stats.work_per_rank``): one tracker per handle, weakly keyed,
    fed each slice's per-rank work."""
    trackers = weakref.WeakKeyDictionary()

    def hook(handle, slice_stats):
        tr = trackers.get(handle)
        if tr is None:
            trackers[handle] = tr = ThroughputTracker(
                n_procs=handle.config.n_procs, alpha=alpha)
        tr.update_work(slice_stats.work_per_rank, slice_stats.seconds)
        if handle.feed.exhausted:
            return None             # nothing left to re-route
        return outer_rebalance(handle, tr, drift_threshold)

    return hook
