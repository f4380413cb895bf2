"""Self-scheduled task planner — the paper's decentralized Map distribution.

A numpy copy of ``repro/core/planner.py``: tasks are fixed-size slices of
the input, and rank r takes tasks {r, r+P, r+2P, ...} (round-robin by
rank — no master, no coordination).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.kv import KEY_SENTINEL


@dataclass(frozen=True)
class TaskPlan:
    n_tasks: int
    task_size: int
    n_procs: int

    @property
    def tasks_per_proc(self) -> int:
        return (self.n_tasks + self.n_procs - 1) // self.n_procs

    def tasks_for_rank(self, rank: int) -> np.ndarray:
        """Round-robin self-schedule; padded with -1 (no-op tasks)."""
        ids = np.arange(rank, self.n_tasks, self.n_procs)
        pad = self.tasks_per_proc - len(ids)
        return np.concatenate([ids, -np.ones(pad, np.int64)]).astype(np.int32)

    def file_offset(self, task_id: int) -> int:
        """Element offset of a task — the non-blocking I/O read target."""
        return task_id * self.task_size


def plan_input(n_elements: int, task_size: int, n_procs: int) -> TaskPlan:
    n_tasks = (n_elements + task_size - 1) // task_size
    return TaskPlan(n_tasks=n_tasks, task_size=task_size, n_procs=n_procs)


def shard_task_ids(plan: TaskPlan) -> np.ndarray:
    """Per-rank (tasks_per_proc,) grid of *global* task ids, -1 for
    padding slots."""
    return np.stack([plan.tasks_for_rank(r) for r in range(plan.n_procs)])


def read_task(source, plan: TaskPlan, task_id: int) -> np.ndarray:
    """Read one task's input by file offset: a (task_size,) int32 block,
    KEY_SENTINEL padded (short reads at EOF, all-sentinel for ids < 0)."""
    out = np.full((plan.task_size,), KEY_SENTINEL, np.int32)
    if task_id >= 0:
        chunk = source.read(plan.file_offset(task_id), plan.task_size)
        out[: len(chunk)] = chunk
    return out


def read_tasks(source, plan: TaskPlan, task_ids: np.ndarray,
               out: np.ndarray | None = None) -> np.ndarray:
    """Vectorized :func:`read_task` over an array of global task ids (any
    shape, -1 for padding), into ``out`` when given. Tasks are read in
    ascending id order, each run of consecutive ids with one
    ``source.read`` (a segment of the round-robin grid is one run), so a
    source that generates or pages in blocks sees each block's tasks
    together."""
    ids = np.asarray(task_ids)
    S = plan.task_size
    if out is None:
        out = np.empty(ids.shape + (S,), np.int32)
    flat_ids = ids.reshape(-1).astype(np.int64)
    flat_out = out.reshape(-1, S)
    order = np.argsort(flat_ids, kind="stable")
    sid = flat_ids[order]
    live = int(np.searchsorted(sid, 0))
    flat_out[order[:live]] = KEY_SENTINEL          # padding tasks
    starts = np.flatnonzero(np.diff(sid[live:]) != 1) + 1 + live
    for lo, hi in zip([live, *starts.tolist()],
                      [*starts.tolist(), len(sid)]):
        if lo == hi:
            continue
        n = hi - lo
        base = plan.file_offset(int(sid[lo]))
        chunk = source.read(base, n * S)
        if len(chunk) < n * S:
            chunk = _read_short(source, base, n * S, S, chunk)
        flat_out[order[lo:hi]] = chunk.reshape(n, S)
    return out


def _read_short(source, base: int, size: int, S: int,
                head: np.ndarray) -> np.ndarray:
    """A run's ``size`` elements from ``base`` after ``source.read``
    returned only ``head``: each task sentinel-padded after its own short
    read, as a read a task gives. A read stops short at the end of the
    stream and, for ``FleetSource``, at the end of a member's elements:
    reading goes on from there, and an empty read skips to the next
    task."""
    buf = np.full((size,), KEY_SENTINEL, np.int32)
    buf[: len(head)] = head
    pos = len(head)
    while pos < size:
        chunk = source.read(base + pos, size - pos)
        if not len(chunk):
            pos = (pos // S + 1) * S               # the next task
            continue
        buf[pos: pos + len(chunk)] = chunk
        pos += len(chunk)
    return buf


def gather_segment(source, plan: TaskPlan, task_id_grid: np.ndarray,
                   out: np.ndarray | None = None) -> np.ndarray:
    """The (n_procs, n, task_size) token block of one segment's task-id
    grid — the only host residency the streaming path needs."""
    return read_tasks(source, plan, task_id_grid, out)
