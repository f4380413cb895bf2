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

Two extensions run the same claim:

  * **coded stealing** (:func:`coded_steal_schedule`): with
    ``code_rate`` r the claim runs over the P/r code groups, each deque
    entry an r-wide column block, so a stolen block lands on every member
    of the claimant group and the group stays decodable;
  * **cross-job co-scheduling** (:func:`fleet_merge`,
    :func:`composite_slots` and ``steal_schedule``'s ``coslots``/
    ``costride``): member jobs' columns merged into one fleet grid of
    composite task ids ``slot * stride + local``, claimed as one job's.
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
    slot_work: np.ndarray | None = None   # (coslots,) executed work per
                                          #   member slot ((1,) solo)

    @property
    def n_stolen(self) -> int:
        return int(self.stolen.sum())

    @property
    def passes(self) -> int:
        """Lockstep repeat passes: the sum over steps of the largest
        repeat a step runs (an idle executor's step runs one)."""
        return int(np.maximum(self.exec_reps, 1).max(axis=0).sum())


def steal_schedule(task_ids, repeats, margin: int = STEAL_MARGIN,
                   work0=None, coslots: int = 1,
                   costride: int = 0) -> StealSchedule:
    """Replay :func:`claim_step` over one (P, n) assignment grid, one round
    a step for all n steps, the work row advanced by each step's executed
    repeats. ``work0`` seeds the work row (cumulative across segments).
    For a composite fleet grid (:func:`fleet_merge`) ``coslots`` and
    ``costride`` split the executed work by member slot into
    ``slot_work``, the host twin of the engine's ``carry.job_work``."""
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
    if coslots > 1:
        assert costride > 0, "composite replay needs the domain stride"
        slot_work = np.zeros((coslots,), np.int64)
        done = exec_ids >= 0
        np.add.at(slot_work, exec_ids[done] // costride,
                  exec_reps[done].astype(np.int64))
    else:
        slot_work = np.asarray([int(exec_reps.sum())], np.int64)
    return StealSchedule(src_rank, src_col, exec_ids, exec_reps,
                         np.asarray(work, np.int32), stolen, slot_work)


@dataclass(frozen=True)
class CodedStealSchedule:
    """The realized schedule of one coded segment under stealing: G = P/r
    group executors, one r-wide block a step each."""
    code_rate: int
    src_group: np.ndarray    # (G, nb) group whose block step k ran (-1 idle)
    src_col: np.ndarray      # (G, nb) block within the source group's
                             #   compacted block row
    src_block: np.ndarray    # (G, nb) that block's index in the segment
    exec_ids: np.ndarray     # (P, nb, r) sub-task ids each rank ran (-1
                             #   padding or idle); a group's rows equal
    exec_reps: np.ndarray    # (P, nb, r) their repeats (0 when idle)
    work: np.ndarray         # (P,) final cumulative work row
    stolen: np.ndarray       # (P,) blocks each rank ran for another group

    @property
    def n_stolen(self) -> int:
        return int(self.stolen.sum())

    @property
    def step_reps(self) -> np.ndarray:
        """(nb,) the repeat each step's lockstep loop runs: the largest
        of its sub-tasks' ``max(rep, 1)`` (an idle group's runs one)."""
        return np.maximum(self.exec_reps, 1).max(axis=(0, 2))

    @property
    def passes(self) -> int:
        return int(self.step_reps.sum())


def coded_steal_schedule(task_ids, repeats, code_rate: int,
                         margin: int = STEAL_MARGIN,
                         work0=None) -> CodedStealSchedule:
    """The coded engine's steal schedule over one (P, n) r-replicated
    segment grid (``core/coded.replicate_grids``; n a multiple of r): the
    claim function of :func:`claim_step` over the G = P/r groups, whose
    deques hold each group's r-wide blocks, live blocks first (stably; a
    block is live when any of its sub-tasks is). A block costs its live
    sub-tasks' repeats; the group work row is ``work.reshape(G, r)[:,
    0]``. Every member of the executor group adds the cost to its work,
    and counts a steal when the block came from another group."""
    ids = np.asarray(task_ids, np.int32)
    reps = np.asarray(repeats, np.int32)
    assert ids.shape == reps.shape
    r = int(code_rate)
    P, n = ids.shape
    assert P % r == 0 and n % r == 0, (ids.shape, r)
    G, nb = P // r, n // r
    gids = ids[::r].reshape(G, nb, r)        # a group's members share a row
    greps = reps[::r].reshape(G, nb, r)
    live = (gids >= 0).any(axis=2)
    perm = np.argsort(~live, axis=1, kind="stable")
    cids = np.take_along_axis(gids, perm[..., None], axis=1)
    creps = np.take_along_axis(greps, perm[..., None], axis=1)
    cost = np.where(cids >= 0, creps, 0).sum(axis=2).tolist()
    head, tail = [0] * G, live.sum(axis=1).tolist()
    work0 = (np.zeros((P,), np.int32) if work0 is None
             else np.asarray(work0, np.int32))
    gwork = work0.reshape(G, r)[:, 0].tolist()
    done = [0] * G
    src_g = np.full((nb, G), -1, np.int32)
    src_c = np.full((nb, G), -1, np.int32)
    left = sum(tail)
    for k in range(nb):
        if not left:
            break
        sg, sc = _claim(head, tail, gwork, margin)
        for e in range(G):
            if sg[e] >= 0:
                c = cost[sg[e]][sc[e]]
                gwork[e] += c
                done[e] += c
                left -= 1
        src_g[k], src_c[k] = sg, sc
    src_g, src_c = src_g.T.copy(), src_c.T.copy()
    on = src_g >= 0
    exec_ids = np.full((G, nb, r), -1, np.int32)
    exec_reps = np.zeros((G, nb, r), np.int32)
    exec_ids[on] = cids[src_g[on], src_c[on]]
    exec_reps[on] = creps[src_g[on], src_c[on]]
    src_block = np.where(on, perm[np.maximum(src_g, 0),
                                  np.maximum(src_c, 0)], -1)
    stolen = (on & (src_g != np.arange(G)[:, None])).sum(axis=1)
    return CodedStealSchedule(
        r, src_g, src_c, src_block.astype(np.int32),
        np.repeat(exec_ids, r, axis=0), np.repeat(exec_reps, r, axis=0),
        (work0 + np.repeat(np.asarray(done, np.int32), r)).astype(np.int32),
        np.repeat(stolen, r).astype(np.int32))


# ---------------------------------------------------------------------------
# the fleet-wide cursor: composite (job, task) grids for cross-job stealing
# ---------------------------------------------------------------------------

def composite_slots(task_ids, stride: int):
    """Member-job slot of each composite task id (-1 for padding)."""
    ids = np.asarray(task_ids, np.int64)
    return np.where(ids >= 0, ids // int(stride), -1).astype(np.int32)


def fleet_merge(task_ids, repeats, *, stride: int,
                priorities=None) -> tuple[np.ndarray, np.ndarray]:
    """Merge K member assignment grids into one fleet grid.

    ``task_ids``/``repeats`` are parallel sequences of (P, T_j) member
    grids (padding id -1). Member j's local ids become composite ids
    ``j * stride + local``; on each rank the columns are ordered by
    priority lane (higher ``priorities[j]`` first, member order within a
    tie) and dealt round-robin across the members of a lane. Returns
    ``(ids, reps)`` of shape (P, N), -1/1 padded. A single-member merge
    keeps the ids and their order."""
    K = len(task_ids)
    assert K == len(repeats) and K >= 1
    stride = int(stride)
    prios = [0] * K if priorities is None else list(priorities)
    assert len(prios) == K
    grids = [np.asarray(g, np.int32) for g in task_ids]
    rgrids = [np.asarray(r, np.int32) for r in repeats]
    P = grids[0].shape[0]
    for g, r in zip(grids, rgrids):
        assert g.shape == r.shape and g.shape[0] == P, \
            "member grids must share the rank count"
        assert g.max(initial=-1) < stride, \
            f"member local ids must fit the stride ({stride})"
    lanes: dict[int, list[int]] = {}
    for j in sorted(range(K), key=lambda j: (-prios[j], j)):
        lanes.setdefault(prios[j], []).append(j)
    rows_ids: list[list[int]] = [[] for _ in range(P)]
    rows_reps: list[list[int]] = [[] for _ in range(P)]
    for r in range(P):
        for prio in sorted(lanes, reverse=True):
            members = lanes[prio]
            cols = [[(int(t), int(rep)) for t, rep in
                     zip(grids[j][r], rgrids[j][r]) if t >= 0]
                    for j in members]
            width = max((len(c) for c in cols), default=0)
            for k in range(width):              # round-robin in the lane
                for j, c in zip(members, cols):
                    if k < len(c):
                        t, rep = c[k]
                        rows_ids[r].append(j * stride + t)
                        rows_reps[r].append(rep)
    N = max((len(row) for row in rows_ids), default=0)
    ids = np.full((P, max(N, 1)), -1, np.int32)
    reps = np.ones((P, max(N, 1)), np.int32)
    for r in range(P):
        ids[r, : len(rows_ids[r])] = rows_ids[r]
        reps[r, : len(rows_reps[r])] = rows_reps[r]
    return ids, reps
