"""Work stealing for the decoupled 1S engine, scheduled on the host.

Counterpart of ``repro/core/steal.py``. The claim function is the
reference's: executors, fastest first (least cumulative work, ties by
rank), each pop the head of their own unstarted column range, or steal
the tail of the most loaded rank that still holds unstarted tasks when
they have fallen ``margin`` work units behind it or their own range is
empty, or idle. Each deque column is popped exactly once, so a task runs
exactly once with no dedup.

The reference computes each claim on the device, inside its scan, from
the replicated ``carry.work`` row. The claim reads nothing else but the
segment's host grid and that row, so here the whole segment's schedule
is computed on the host before the segment runs (:func:`steal_schedule`,
plain Python ints over the P rows), and the engine
(``core/onesided.py``) gathers each step's column from it: every step's
input and max repeat are known before its graph replays, and the
device's schedule equals the host replay by construction.

``fleet_merge`` and ``composite_slots`` (cross-job co-scheduling) and
the coded steal segment are not ported yet: ROADMAP Queue 1 items 10
and 9.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Work-unit hysteresis: a rank claims a peer's task only when the peer's
# cumulative work exceeds its own by at least this margin (one unit, one
# compute repeat), so strictly uniform task costs never steal.
STEAL_MARGIN = 1


def _claim(head: list, tail: list, work: list, margin: int):
    """One claim round on Python lists; ``head`` and ``tail`` are updated
    in place. Returns ``(src_rank, src_col)`` lists, -1 for an idle
    executor."""
    P = len(head)
    src_r = [-1] * P
    src_c = [-1] * P
    # the victim is the reference's argmax of work over the ranks with
    # unstarted tasks (-1 elsewhere): the first of them in the order of
    # most work, then rank. Deques only shrink within a round, so one
    # pointer walks that order once a round.
    heavy = sorted(range(P), key=work.__getitem__, reverse=True)
    i = 0
    for e in sorted(range(P), key=work.__getitem__):   # fastest first
        while i < P and tail[heavy[i]] <= head[heavy[i]]:
            i += 1
        if i < P and work[heavy[i]] > -1:
            v = heavy[i]
        else:                  # a work row below 0: the argmax itself
            v = max(range(P), key=lambda r: work[r] if tail[r] > head[r]
                    else -1)
        own = tail[e] > head[e]
        if (tail[v] > head[v] and v != e
                and (not own or work[v] - work[e] >= margin)):
            tail[v] -= 1
            src_r[e], src_c[e] = v, tail[v]
        elif own:
            src_r[e], src_c[e] = e, head[e]
            head[e] += 1
    return src_r, src_c


def claim_step(head, tail, work, margin: int = STEAL_MARGIN):
    """One scheduling round of the work-stealing claim.

    ``head``/``tail`` (P,) are the cursors into each rank's unstarted
    column range ``[head[v], tail[v])``; ``work`` (P,) is the cumulative
    work row. Returns int32 ``(src_rank, src_col, head, tail)``: executor
    ``e`` runs the task at column ``src_col[e]`` of rank ``src_rank[e]``'s
    compacted grid row (-1 when it idles)."""
    head = np.asarray(head, np.int32).tolist()
    tail = np.asarray(tail, np.int32).tolist()
    src_r, src_c = _claim(head, tail, np.asarray(work, np.int32).tolist(),
                          margin)
    return tuple(np.asarray(x, np.int32) for x in (src_r, src_c, head, tail))


def segment_cursors(task_ids):
    """Initial ``(head, tail)`` rows of one (P, n) segment grid: ``tail``
    counts each rank's real columns (padding id -1 is no deque entry)."""
    tail = (np.asarray(task_ids) >= 0).sum(axis=1).astype(np.int32)
    return np.zeros_like(tail), tail


def compact_columns(task_ids):
    """Permutation of each grid row putting its real columns before its
    padding, stably (the deques address dense ``[0, count)`` ranges)."""
    return np.argsort(np.asarray(task_ids) < 0, axis=-1, kind="stable")


@dataclass(frozen=True)
class StealSchedule:
    """The realized execution schedule of one segment under stealing."""
    src_rank: np.ndarray     # (P, n) rank whose slot step k executed (-1 idle)
    src_col: np.ndarray      # (P, n) column within the source rank's
                             #   compacted row
    exec_ids: np.ndarray     # (P, n) global task id executed (-1 idle)
    exec_reps: np.ndarray    # (P, n) compute-repeats executed (0 idle)
    work: np.ndarray         # (P,) final cumulative work row
    stolen: np.ndarray       # (P,) tasks each rank executed for a peer
    slot_work: np.ndarray | None = None   # (1,) executed work of the job

    @property
    def n_stolen(self) -> int:
        return int(self.stolen.sum())

    @property
    def passes(self) -> int:
        """Lockstep repeat passes: the sum over steps of the largest
        repeat a step runs (an idle executor's step runs one)."""
        return int(np.maximum(self.exec_reps, 1).max(axis=0).sum())


def steal_schedule(task_ids, repeats, margin: int = STEAL_MARGIN,
                   work0=None) -> StealSchedule:
    """Replay :func:`claim_step` over one (P, n) assignment grid, one round
    a step for all n steps, the work row advanced by each step's executed
    repeats. ``work0`` seeds the work row (cumulative across segments)."""
    ids = np.asarray(task_ids, np.int32)
    reps = np.asarray(repeats, np.int32)
    assert ids.shape == reps.shape
    P, n = ids.shape
    perm = compact_columns(ids)
    cids = np.take_along_axis(ids, perm, axis=1)
    creps = np.take_along_axis(reps, perm, axis=1)
    rep_rows = creps.tolist()
    head, tail = (x.tolist() for x in segment_cursors(ids))
    work = ([0] * P if work0 is None
            else np.asarray(work0, np.int32).tolist())
    src_rank = np.full((n, P), -1, np.int32)
    src_col = np.full((n, P), -1, np.int32)
    left = sum(tail)
    for k in range(n):
        if not left:                      # every deque empty: all idle
            break
        sr, sc = _claim(head, tail, work, margin)
        for e in range(P):
            if sr[e] >= 0:
                work[e] += rep_rows[sr[e]][sc[e]]
                left -= 1
        src_rank[k], src_col[k] = sr, sc
    src_rank, src_col = src_rank.T.copy(), src_col.T.copy()
    live = src_rank >= 0
    exec_ids = np.full((P, n), -1, np.int32)
    exec_reps = np.zeros((P, n), np.int32)
    exec_ids[live] = cids[src_rank[live], src_col[live]]
    exec_reps[live] = creps[src_rank[live], src_col[live]]
    stolen = (live & (src_rank != np.arange(P)[:, None])
              & (exec_ids >= 0)).sum(axis=1).astype(np.int32)
    return StealSchedule(src_rank, src_col, exec_ids, exec_reps,
                         np.asarray(work, np.int32), stolen,
                         np.asarray([int(exec_reps.sum())], np.int64))
