"""WorkDomain: cross-job co-scheduling, several jobs in one engine run.

Counterpart of ``repro/core/workdomain.py``, with ``device=`` in place of
the reference's ``mesh=``. K admitted jobs that share one program (the
same backend, ``JobSpec`` and ``map_fn``) merge into one composite
engine run, so a rank that has drained job A's tail runs job B's tasks
in the same step: work stealing across job boundaries (OS4M,
arXiv:1406.3901). The merge is an encoding:

  * **composite task ids**: member j's task t is ``j * costride + t``
    (``steal.fleet_merge`` lays the members' columns into one grid,
    priority lanes first, round-robin within a lane). A
    :class:`~repro_torch.data.source.FleetSource` puts member j's
    elements at ``j * costride * task_size``, so ``plan.file_offset``
    reads any member's task and the feed serves cross-job reads as it is;
  * **composite keys**: the step offsets each emitted key by ``slot *
    (vocab // coslots)`` into its member's window slice
    (``onesided._composite_map``), so every member's records are its
    solo run's, wherever stealing ran its tasks;
  * **executed work**: ``carry.job_work`` holds each member's executed
    repeats, which the scheduler's fair share charges.

A member finishes as soon as the shared cursor has read all its columns:
the finish runs on a copy of the carry's window (the domain keeps
stepping), the records are split out by key range, and the member's
handle adopts its :class:`~repro_torch.core.job.JobResult`.

Eligibility (:func:`can_coschedule`): segmented ``"1s"`` jobs, not
started, of one program, with a partitioner that needs no sample and no
``fused_map`` or ``code_rate`` > 1, which the composite step refuses.

The domain checkpoints once, through its handle: the composite carry,
the shared cursor and the merged grids, tagged with its members, so a
scheduler can re-form it before restoring.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import steal
from repro_torch.core.job import JobHandle, JobResult
from repro_torch.core.kv import KEY_SENTINEL
from repro_torch.core.planner import TaskPlan
from repro_torch.core.usecase import finalize
from repro_torch.data.feed import SegmentFeed
from repro_torch.data.source import FleetSource


def coschedule_key(handle: JobHandle) -> tuple:
    """Program-compatibility key: jobs that share it can merge into one
    WorkDomain (the scheduler's program key)."""
    return (handle.backend.name, handle.spec, id(handle._map_fn))


def can_coschedule(handle: JobHandle) -> bool:
    """Whether this job may join a WorkDomain: fused and coded jobs and
    sampling partitioners stay solo (the fused kernel has no composite
    keys, the coded decode claims whole blocks, a sampled owner map is
    built over one job's key space)."""
    spec = handle.spec
    return (getattr(handle.backend, "supports_coschedule", False)
            and spec.coslots == 1
            and not spec.fused_map
            and spec.code_rate == 1
            and not handle.partitioner.needs_sample
            and handle.config.segment > 0
            and handle.cursor == 0
            and handle._carry is None
            and handle._result is None)


class WorkDomain:
    """K program-compatible jobs in one co-scheduled engine run.

    ``handles`` must all pass :func:`can_coschedule` and share
    :func:`coschedule_key`. ``pack`` member segments make one domain
    segment (default K); ``stride`` overrides the task-id stride (a
    restore passes the recorded one); ``device`` defaults to the first
    member's."""

    def __init__(self, handles: list[JobHandle], *, names=None,
                 priorities=None, device=None, pack: int | None = None,
                 stride: int | None = None, feed_budget=None):
        if len(handles) < 2:
            raise ValueError("a WorkDomain needs at least two member "
                             "jobs (one job co-schedules with nobody)")
        key0 = coschedule_key(handles[0])
        for h in handles:
            if not can_coschedule(h):
                raise ValueError(
                    "job is not co-schedulable (backend without "
                    "supports_coschedule, fused_map, code_rate > 1, "
                    "sampling partitioner, oneshot, or already started)")
            if coschedule_key(h) != key0:
                raise ValueError(
                    "WorkDomain members must share one program (backend, "
                    f"JobSpec, use-case): {coschedule_key(h)} != {key0}")
        self.members = list(handles)
        self.names = (list(names) if names is not None
                      else [f"member-{j}" for j in range(len(handles))])
        assert len(self.names) == len(self.members)
        self.priorities = (list(priorities) if priorities is not None
                           else [0] * len(self.members))
        self.K = len(self.members)
        spec0 = self.members[0].spec
        cfg0 = self.members[0].config
        need = max(h.plan.n_tasks for h in self.members)
        self.stride = int(stride) if stride is not None else need
        if self.stride < need:
            raise ValueError(f"stride {self.stride} < widest member "
                             f"({need} tasks)")
        self.pack = int(pack) if pack else self.K
        self.device = (device if device is not None
                       else self.members[0].device)

        # K disjoint window slices, pack-wide segments
        seg_d = spec0.segment * self.pack
        self.spec = dataclasses.replace(
            spec0, vocab=spec0.vocab * self.K,
            combine_capacity=spec0.combine_capacity * self.K,
            segment=seg_d, coslots=self.K, costride=self.stride)
        config = dataclasses.replace(cfg0, segment=seg_d)
        source = FleetSource([h.feed.source for h in self.members],
                             self.stride * spec0.task_size)
        plan = TaskPlan(n_tasks=self.K * self.stride,
                        task_size=spec0.task_size, n_procs=spec0.n_procs)
        ids, reps = steal.fleet_merge(
            [h.feed.task_ids_grid for h in self.members],
            [h.feed.repeats_grid for h in self.members],
            stride=self.stride, priorities=self.priorities)
        feed = SegmentFeed(source, plan, ids, reps, segment=seg_d,
                           device=self.device, prefetch=True,
                           budget=feed_budget)
        self.handle = JobHandle(config, self.members[0].backend, self.spec,
                                self.device, plan, feed,
                                self.members[0].partitioner)
        # members run no engine of their own: their feeds stop now (the
        # grids stay readable for their results)
        self._member_grids = [
            (np.array(h.feed.task_ids_grid), np.array(h.feed.repeats_grid))
            for h in self.members]
        self._member_n_tasks = [int((g >= 0).sum())
                                for g, _ in self._member_grids]
        for h in self.members:
            h.feed.close()
        self._finalized: set[int] = set()

    # -- introspection -------------------------------------------------------

    @property
    def done(self) -> bool:
        return len(self._finalized) == self.K

    def ready(self) -> bool:
        return self.handle.ready()

    def job_work(self) -> np.ndarray:
        """Executed work per member slot so far: the replicated
        ``carry.job_work`` row (zeros before the first step)."""
        if self.handle._carry is None:
            return np.zeros((self.K,), np.int64)
        return self.handle._carry.job_work[0].cpu().numpy().astype(np.int64)

    # -- execution -----------------------------------------------------------

    def step(self, n_segments: int = 1) -> bool:
        """Advance the shared cursor by up to ``n_segments`` domain
        segments. Returns True while map work remains."""
        return self.handle.step(n_segments)

    def collect_finished(self) -> dict[str, JobResult]:
        """Finish every member whose columns the shared cursor has read
        (and that is not finished yet); its handle adopts its result.
        Returns ``{name: result}`` of the members finished now."""
        consumed = self.handle.feed.consumed_task_ids()
        counts = (np.bincount(consumed // self.stride, minlength=self.K)
                  if len(consumed) else np.zeros((self.K,), np.int64))
        newly = [j for j in range(self.K) if j not in self._finalized
                 and counts[j] >= self._member_n_tasks[j]]
        if not newly:
            return {}
        results = self._finalize(newly)
        self._finalized.update(newly)
        return {self.names[j]: results[j] for j in newly}

    def _finalize(self, slots: list[int]) -> dict[int, JobResult]:
        """Drain and combine a copy of the carry's window (the domain
        keeps stepping on the carry) and split its records for
        ``slots``."""
        h = self.handle
        assert h._carry is not None, "no carry — domain never stepped"
        _, _, fin_fn = h._seg_fns
        # the drain folds the in-flight chunk into the window in place
        keys, vals, overflow = fin_fn(
            h._carry._replace(table=h._carry.table.clone()))
        keys = keys[0].cpu().numpy()
        vals = vals[0].cpu().numpy()
        overflow = int(overflow[0])
        valid = keys != KEY_SENTINEL
        keys, vals = keys[valid], vals[valid]
        base = self.spec.vocab // self.K
        jw = self.job_work()
        total = max(int(jw.sum()), 1)
        out: dict[int, JobResult] = {}
        for j in slots:
            inside = (keys >= j * base) & (keys < (j + 1) * base)
            lk = (keys[inside] - j * base).astype(keys.dtype)
            lv = vals[inside]
            records = dict(zip(lk.tolist(), lv.tolist()))
            member = self.members[j]
            gids, greps = self._member_grids[j]
            task_valid = gids >= 0
            out[j] = JobResult(
                records=records,
                output=finalize(member.config.usecase, records),
                keys=lk, values=lv,
                # the domain's seconds split by executed work share
                wall_time=h._wall * (int(jw[j]) / total),
                backend=h.backend.name,
                n_tasks=member.plan.n_tasks,
                tasks_per_rank=task_valid.sum(axis=1),
                work_per_rank=(greps * task_valid).sum(axis=1),
                steals_per_rank=np.zeros((self.spec.n_procs,), np.int32),
                partitioner=self.spec.partitioner,
                n_split_keys=0,
                combine_overflow=overflow,
            )
            member.adopt_result(out[j])
        return out

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Stop the domain's feed (the members' are closed). Idempotent."""
        self.handle.close()

    def checkpoint(self, manager):
        """One snapshot for the whole domain through its handle, tagged
        with the members, the stride and the pack."""
        return self.handle.checkpoint(
            manager, domain_members=list(self.names),
            domain_stride=self.stride, domain_pack=self.pack)

    def restore(self, manager) -> WorkDomain:
        """Resume a snapshot of this domain: the composite carry, the
        shared cursor and the merged grids. Call :meth:`collect_finished`
        after it to finish the members the saved cursor had drained."""
        found, extra = manager.peek(None)
        saved = extra.get("domain_members")
        if saved is not None and list(saved) != list(self.names):
            raise ValueError(
                f"domain snapshot at step {found} was taken over members "
                f"{list(saved)} — this domain has {list(self.names)}; "
                "re-form the WorkDomain with the same jobs in the same "
                "order")
        self.handle.restore(manager)
        return self
