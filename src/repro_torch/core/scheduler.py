"""Multi-tenant job scheduler: many JobHandles time-sliced over one device.

Counterpart of ``repro/core/scheduler.py``, with ``device=`` in place of
the reference's ``mesh=``. When *jobs* are unbalanced, a long job must
not serialize every other tenant behind it; the segmented engines expose
the granularity to prevent that (``JobHandle.step()`` runs one segment),
so a host-side scheduler time-slices many live jobs over one device::

    sched = JobScheduler(policy="fair", max_live_bytes=256 << 20)
    h1 = sched.submit(cfg_big,   corpus,  tenant="batch")
    h2 = sched.submit(cfg_small, queries, tenant="interactive",
                      priority=1)
    results = sched.run_until_complete()       # {name: JobResult}

The cooperative contract with :class:`~repro_torch.core.job.JobHandle`:

  * ``step()``  — runs one segment, then yields the host thread back;
  * ``ready()`` — True when the next step would not block on input I/O,
    so the scheduler polls N feeds without blocking on any of them.

What tenants share differs from the reference. There, jobs with the same
``(backend, JobSpec, map_fn)`` share one compiled engine. Here a job's
engine (``onesided.SegmentFns``) holds the fused step's CUDA graphs,
captured on *that job's* carry buffers, so an engine shared by two
handles would replay one job's steps into the other's window. Each
handle therefore keeps its own engine and graphs; the tenants of one
use-case share its memoized ``map_fn`` and the one loaded kernel
extension. ``n_unique_programs`` counts distinct ``(backend, spec,
id(map_fn))`` keys, as the reference's does, and :meth:`JobScheduler.
_mark_live` asserts the sharing that holds: the key's ``map_fn`` is the
handle's, and a fused handle's graphs write its own carry.

Every feed the scheduler creates shares one
:class:`~repro_torch.data.feed.FeedBudget`, so N tenants prefetching
at once cannot exhaust the host; a bounded admission queue
(``max_pending``) pushes back on submit. Per-tenant accounting (segments
run, work executed, host seconds) feeds the fair-share policy. A slice's
seconds are host seconds: on the card ``step()`` returns once the
segment's steps are queued, and the scheduler adds no synchronization
between slices; a job's completion stamp follows ``result()``, which
reads its records back.

Scheduling policies are pluggable (:class:`SchedulePolicy`):

  * ``"fifo"``     — strict admission order, the head-of-line baseline;
  * ``"fair"``     — least service first across tenants (processor
    sharing at segment granularity); among the least served, a job whose
    next segment has landed goes first, so two runs can slice in
    different orders;
  * ``"priority"`` — highest priority first, FIFO inside a class.

A fleet checkpoint (:meth:`JobScheduler.checkpoint`) is the set of
per-job snapshots plus the queue state
(:class:`~repro_torch.ckpt.checkpoint.FleetCheckpoint`, the reference's
layout); restore seeks every live job's feed, and
``repro_torch.ft.straggler.rebalance_hook`` plugs the coarse re-planning
loop in as a per-job ``on_slice`` hook.

Cross-job co-scheduling (``coschedule=True``): jobs of one program that
are activated together merge into a
:class:`~repro_torch.core.workdomain.WorkDomain`, one engine run whose
steps run several tenants' tasks; a slice of any member advances the
domain, each tenant is charged the work its jobs executed
(``carry.job_work``), and a member finishes as soon as its columns are
read. Domains run the unfused step, so they hold no step graphs. The
fleet manifest lists the domains, and ``restore`` re-forms them.
"""
from __future__ import annotations

import time
from collections import defaultdict
from collections.abc import Callable, Sequence
from dataclasses import asdict, dataclass
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.job import JobConfig, JobHandle, JobResult
from repro_torch.core.job import submit as _submit
from repro_torch.data.feed import FeedBudget
from repro_torch.device import resolve_device

QUEUED, LIVE, DONE, FAILED = "queued", "live", "done", "failed"


class AdmissionQueueFull(RuntimeError):
    """Backpressure: the scheduler's bounded admission queue is at
    ``max_pending`` open jobs. Catch it and retry after
    ``run_until_complete`` drains."""


@dataclass
class TenantStats:
    """Per-tenant service accounting (the currency of fair share)."""
    segments: int = 0        # engine segments executed for this tenant
    work: int = 0            # compute-repeat units executed
    wall: float = 0.0        # host seconds spent on this tenant's slices
    jobs_done: int = 0
    jobs_failed: int = 0


@dataclass
class SliceStats:
    """What one slice executed: handed to ``on_slice`` hooks (e.g.
    ``repro_torch.ft.straggler.rebalance_hook``) and charged to the
    tenant (``work_executed`` lands in ``TenantStats.work``)."""
    seconds: float
    segments: int
    work_per_rank: np.ndarray    # assigned work consumed this slice (P,)
    work_executed: int = 0       # compute-repeats executed this slice


@dataclass
class ScheduledJob:
    """One admitted job: the handle plus scheduling metadata."""
    name: str
    tenant: str
    priority: int
    seq: int                     # admission order (FIFO key)
    handle: JobHandle
    on_slice: Callable | None = None
    state: str = QUEUED
    segments_run: int = 0
    work_done: int = 0
    wall: float = 0.0            # host seconds across this job's slices
    submitted_at: float = 0.0    # perf_counter stamps
    finished_at: float | None = None
    error: BaseException | None = None
    domain: object | None = None     # the WorkDomain this job runs in
                                     #   (core/workdomain.py), if any

    @property
    def ready(self) -> bool:
        if self.domain is not None:
            return self.domain.ready()
        return self.handle.ready()


@runtime_checkable
class SchedulePolicy(Protocol):
    """Pick the next job to slice. ``candidates`` is the non-empty list
    of live jobs (admission order); ``tenants`` the scheduler's
    accounting by tenant name. Must return one candidate."""

    name: str

    def pick(self, candidates: Sequence[ScheduledJob],
             tenants: dict[str, TenantStats]) -> ScheduledJob:
        ...


class FifoPolicy:
    """Strict admission order: the head-of-line-blocking baseline."""
    name = "fifo"

    def pick(self, candidates, tenants):
        return min(candidates, key=lambda j: j.seq)


class PriorityPolicy:
    """Highest ``priority`` first; FIFO inside a priority class."""
    name = "priority"

    def pick(self, candidates, tenants):
        return min(candidates, key=lambda j: (-j.priority, j.seq))


class FairSharePolicy:
    """Least service first across tenants. The tenant that has executed
    the least work runs next; within that set, jobs whose next segment
    has landed (``ready``) go first; admission order breaks the tie."""
    name = "fair"

    def pick(self, candidates, tenants):
        def service(j):
            return tenants[j.tenant].work
        least = min(service(j) for j in candidates)
        pool = [j for j in candidates if service(j) == least]
        ready = [j for j in pool if j.ready]
        return min(ready or pool, key=lambda j: j.seq)


_POLICIES = {p.name: p for p in (FifoPolicy, FairSharePolicy,
                                 PriorityPolicy)}


def available_policies() -> list[str]:
    return sorted(_POLICIES)


def resolve_policy(policy: str | SchedulePolicy) -> SchedulePolicy:
    if isinstance(policy, str):
        if policy not in _POLICIES:
            raise ValueError(f"unknown policy {policy!r}; available: "
                             f"{available_policies()}")
        return _POLICIES[policy]()
    if not isinstance(policy, SchedulePolicy):
        raise TypeError(f"{policy!r} does not implement SchedulePolicy")
    return policy


class JobScheduler:
    """Admit many jobs and time-slice them at segment granularity over
    one device. See the module docstring for the contract.

    Parameters
    ----------
    policy:         ``"fifo" | "fair" | "priority"`` or any
                    :class:`SchedulePolicy` instance.
    device:         where every job runs (cuda unless given).
    max_pending:    bounded admission queue: ``submit`` raises
                    :class:`AdmissionQueueFull` past this many open
                    (queued + live) jobs.
    max_active:     at most this many jobs are live (feeds prefetching,
                    being sliced) at once; the rest wait in admission
                    order. ``None``: every admitted job is live.
    max_live_bytes: a shared :class:`~repro_torch.data.feed.FeedBudget`
                    over every feed's in-flight prefetch bytes (``None``:
                    unbounded).
    slice_segments: segments a time slice (1 = finest interleaving).
    coschedule:     merge program-compatible jobs activated together into
                    :class:`~repro_torch.core.workdomain.WorkDomain` runs;
                    the others (fused, coded, sampled, ``"2s"``, a job
                    alone) slice solo.
    copack:         member segments a domain segment (default: the
                    domain's size K).
    """

    def __init__(self, *, policy: str | SchedulePolicy = "fair",
                 device=None, max_pending: int | None = None,
                 max_active: int | None = None,
                 max_live_bytes: int | None = None,
                 slice_segments: int = 1,
                 coschedule: bool = False,
                 copack: int | None = None):
        self.policy = resolve_policy(policy)
        self.device = resolve_device(device)
        self.max_pending = max_pending
        self.max_active = max_active
        self.slice_segments = int(slice_segments)
        self.coschedule = bool(coschedule)
        self.copack = copack
        self.budget = (FeedBudget(max_live_bytes)
                       if max_live_bytes else None)
        self.jobs: list[ScheduledJob] = []
        self.tenants: dict[str, TenantStats] = defaultdict(TenantStats)
        self.run_started_at: float | None = None
        self._by_name: dict[str, ScheduledJob] = {}
        self._programs: dict = {}        # (backend, spec, id(map_fn)) -> map_fn
        self._domains: list = []         # WorkDomains, in order formed
        self._n_procs: int | None = None

    # -- admission -----------------------------------------------------------

    def submit(self, config: JobConfig, dataset, *, priority: int = 0,
               tenant: str = "default", name: str | None = None,
               on_slice: Callable | None = None,
               repeats=None) -> JobHandle:
        """Admit a job; returns its :class:`JobHandle` (nothing executes
        until :meth:`run_until_complete`; after it, ``handle.result()``
        is the cached outcome). Jobs must be segmented
        (``JobConfig(segment=N)``): a oneshot job cannot yield the device
        between segments."""
        if config.segment <= 0:
            raise ValueError(
                "JobScheduler needs segmented jobs — set "
                "JobConfig(segment=N); a oneshot job runs its whole "
                "input in one step() and cannot be time-sliced")
        n_open = sum(j.state in (QUEUED, LIVE) for j in self.jobs)
        if self.max_pending is not None and n_open >= self.max_pending:
            raise AdmissionQueueFull(
                f"admission queue full: {n_open} open job(s) >= "
                f"max_pending={self.max_pending}; run_until_complete() "
                "(or raise max_pending) before submitting more")
        if self._n_procs is None:
            self._n_procs = config.n_procs
        elif config.n_procs != self._n_procs:
            raise ValueError(
                f"all jobs multiplex over ONE device with one rank count: "
                f"scheduler runs n_procs={self._n_procs}, job asked for "
                f"{config.n_procs}")
        name = name or f"job-{len(self.jobs)}"
        if name in self._by_name:
            raise ValueError(f"duplicate job name {name!r}")
        handle = _submit(config, dataset, device=self.device,
                         repeats=repeats, feed_budget=self.budget)
        job = ScheduledJob(name=name, tenant=tenant, priority=priority,
                           seq=len(self.jobs), handle=handle,
                           on_slice=on_slice,
                           submitted_at=time.perf_counter())
        self.jobs.append(job)
        self._by_name[name] = job
        self.tenants[tenant]                  # materialize the entry
        return handle

    def evict(self, name: str) -> ScheduledJob:
        """Remove a job from the scheduler (its feed is closed, its name
        becomes reusable): a FAILED job is evicted before a fresh handle
        is admitted under its name and restored from its snapshot.
        Returns the evicted record; tenant totals already include it."""
        job = self._by_name.get(name)
        if job is None:
            raise KeyError(f"no job named {name!r} to evict")
        if job.domain is not None and not job.domain.done:
            raise RuntimeError(
                f"job {name!r} is co-scheduled in a live WorkDomain — "
                "members share one engine run and cannot be evicted "
                "individually (fail/finish the domain first)")
        del self._by_name[name]
        self.jobs.remove(job)
        job.handle.close()
        return job

    def close(self):
        """Stop every job's feed. Idempotent; results already computed
        stay readable on their handles."""
        for j in self.jobs:
            j.handle.close()
        for d in self._domains:
            d.close()

    # -- introspection -------------------------------------------------------

    def __getitem__(self, name: str) -> ScheduledJob:
        return self._by_name[name]

    @property
    def n_unique_programs(self) -> int:
        """Distinct ``(backend, spec, use-case)`` programs serving the
        fleet (each handle still has its own engine: module docstring)."""
        return len(self._programs)

    def latency(self, name: str) -> float:
        """Seconds from run start to the job's completion."""
        j = self._by_name[name]
        if j.finished_at is None or self.run_started_at is None:
            raise RuntimeError(f"{name} has not finished")
        return j.finished_at - self.run_started_at

    def results(self) -> dict[str, JobResult]:
        """Results of every completed job (failed jobs carry their
        exception on ``scheduler[name].error`` instead)."""
        return {j.name: j.handle.result()
                for j in self.jobs if j.state == DONE}

    def stats(self) -> dict:
        """JSON-able snapshot of fleet accounting (the reference's keys)."""
        return {
            "policy": self.policy.name,
            "n_unique_programs": self.n_unique_programs,
            "budget_live_bytes": (self.budget.live_bytes
                                  if self.budget else None),
            "tenants": {t: asdict(s) for t, s in self.tenants.items()},
            "jobs": [{
                "name": j.name, "tenant": j.tenant, "state": j.state,
                "priority": j.priority, "segments_run": j.segments_run,
                "work_done": j.work_done, "wall": j.wall,
            } for j in self.jobs],
        }

    # -- the scheduling loop -------------------------------------------------

    def _register(self, h: JobHandle):
        """Make the handle's own engine and carry and register its
        program, asserting that the key's ``map_fn`` is the handle's."""
        h._ensure_engine()
        key = (h.backend.name, h.spec, id(h._map_fn))
        shared = self._programs.setdefault(key, h._map_fn)
        assert shared is h._map_fn, (
            f"program {key[:2]} registered another map_fn under its id")

    def _mark_live(self, job: ScheduledJob):
        """Activate: make the job's own engine and carry, register its
        program, assert what the tenants share, start the feed's first
        prefetch."""
        h = job.handle
        self._register(h)
        graphs = getattr(h._seg_fns, "graphs", None)
        if graphs is not None:
            # the graphs replay into the carry they were captured on: it
            # must be this job's, never a sibling's
            assert all(g.data_ptr() == c.data_ptr()
                       for g, c in zip(graphs.carry, h._carry,
                                       strict=True)), (
                f"job {job.name!r}'s step graphs write another carry")
        h.feed.prime()
        job.state = LIVE

    def _form_domain(self, group: list[ScheduledJob], *, pack=None,
                     stride=None):
        """Merge a program-compatible group into one WorkDomain and mark
        every member live. The domain's program (its spec differs by
        ``coslots``/``costride``) registers like a solo one; it runs the
        unfused step, so it holds no step graphs."""
        from repro_torch.core.workdomain import WorkDomain
        domain = WorkDomain(
            [j.handle for j in group], names=[j.name for j in group],
            priorities=[j.priority for j in group], device=self.device,
            pack=pack if pack is not None else self.copack,
            stride=stride, feed_budget=self.budget)
        h = domain.handle
        self._register(h)
        assert getattr(h._seg_fns, "graphs", None) is None
        h.feed.prime()
        for j in group:
            j.domain = domain
            j.state = LIVE
        self._domains.append(domain)
        return domain

    def _activate(self):
        n_live = sum(j.state == LIVE for j in self.jobs)
        batch: list[ScheduledJob] = []
        for job in self.jobs:
            if job.state != QUEUED:
                continue
            if self.max_active is not None and n_live >= self.max_active:
                break
            batch.append(job)
            n_live += 1
        if self.coschedule:
            # program-compatible eligible jobs activated together merge
            # into one WorkDomain; the others slice solo
            from repro_torch.core.workdomain import (can_coschedule,
                                                     coschedule_key)
            groups: dict = defaultdict(list)
            for job in batch:
                if can_coschedule(job.handle):
                    groups[coschedule_key(job.handle)].append(job)
            for group in groups.values():
                if len(group) >= 2:
                    self._form_domain(group)
        for job in batch:
            if job.state == QUEUED:
                self._mark_live(job)

    def _charge(self, job: ScheduledJob, st: SliceStats):
        """Fold one slice's executed service into the job's and its
        tenant's accounting."""
        job.segments_run += st.segments
        job.work_done += st.work_executed
        job.wall += st.seconds
        ts = self.tenants[job.tenant]
        ts.segments += st.segments
        ts.work += st.work_executed
        ts.wall += st.seconds

    def _slice(self, job: ScheduledJob, raise_on_error: bool):
        if job.domain is not None:
            self._slice_domain(job, job.domain, raise_on_error)
            return
        h = job.handle
        c0 = h.cursor
        t0 = time.perf_counter()
        try:
            if not h.step(self.slice_segments):
                h.result()           # drained: combine/finalize + close
                job.state = DONE
        except Exception as e:       # noqa: BLE001 — isolate the tenant
            job.state = FAILED
            job.error = e
            h.close()                # never leak the feed's prefetch
            if raise_on_error:
                raise
        dt = time.perf_counter() - t0
        c1 = h.cursor
        ids = h.feed.task_ids_grid[:, c0:c1]
        reps = h.feed.repeats_grid[:, c0:c1]
        work = (reps * (ids >= 0)).sum(axis=1).astype(np.int64)
        seg_w = h.feed.segment
        segs = (c1 - c0 + seg_w - 1) // seg_w
        # a solo slice executes exactly its assignment (stealing only
        # moves work between ranks inside the job): assigned == executed;
        # the host grids, so no read of the device
        st = SliceStats(seconds=dt, segments=segs, work_per_rank=work,
                        work_executed=int(work.sum()))
        self._charge(job, st)
        ts = self.tenants[job.tenant]
        if job.state == DONE:
            ts.jobs_done += 1
            job.finished_at = time.perf_counter()
        elif job.state == FAILED:
            ts.jobs_failed += 1
            job.finished_at = time.perf_counter()
        elif job.on_slice is not None:
            job.on_slice(h, st)

    def _slice_domain(self, picked: ScheduledJob, domain,
                      raise_on_error: bool):
        """Advance a WorkDomain one slice: its segments run a mix of the
        members' tasks; each member is charged the work its slot executed
        (``job_work`` deltas, read back from the device), and members
        whose columns are all read finish. A failing domain fails every
        member: they share one engine run."""
        members = [self._by_name[n] for n in domain.names]
        jw0 = domain.job_work()
        c0 = domain.handle.cursor
        t0 = time.perf_counter()
        try:
            domain.step(self.slice_segments)
            finished = domain.collect_finished()
        except Exception as e:       # noqa: BLE001 — isolate the domain
            domain.close()
            now = time.perf_counter()
            for j in members:
                if j.state == LIVE:
                    j.state = FAILED
                    j.error = e
                    j.finished_at = now
                    self.tenants[j.tenant].jobs_failed += 1
            if raise_on_error:
                raise
            return
        dt = time.perf_counter() - t0
        dw = domain.job_work() - jw0
        seg_w = domain.handle.feed.segment
        segs = (domain.handle.cursor - c0 + seg_w - 1) // seg_w
        total = max(int(dw.sum()), 1)
        for slot, j in enumerate(members):
            if int(dw[slot]) == 0 and j is not picked:
                continue
            self._charge(j, SliceStats(
                seconds=dt * (int(dw[slot]) / total),
                # the picked member funded the slice; the service charged
                # is the work above
                segments=segs if j is picked else 0,
                work_per_rank=np.zeros((self._n_procs or 0,), np.int64),
                work_executed=int(dw[slot])))
        now = time.perf_counter()
        for name in finished:
            j = self._by_name[name]
            j.state = DONE
            j.finished_at = now
            self.tenants[j.tenant].jobs_done += 1

    def run_until_complete(self, *, max_slices: int | None = None,
                           raise_on_error: bool = False
                           ) -> dict[str, JobResult]:
        """Drive the fleet until every job is done or failed (or
        ``max_slices`` slices ran: call again to continue). A failing
        job is isolated: its feed is closed, its error kept on
        ``scheduler[name].error``, and its siblings keep running, unless
        ``raise_on_error`` asks for fail-fast. Returns :meth:`results`."""
        if self.run_started_at is None:
            self.run_started_at = time.perf_counter()
        n = 0
        while max_slices is None or n < max_slices:
            self._activate()
            live = [j for j in self.jobs if j.state == LIVE]
            if not live:
                break
            self._slice(self.policy.pick(live, self.tenants),
                        raise_on_error)
            n += 1
        return self.results()

    # -- fleet checkpoint / restore ------------------------------------------

    def checkpoint(self, fleet):
        """Snapshot the fleet: every live job's carry and feed position
        (async, overlapping the next slices) plus the queue state.
        ``fleet`` is a :class:`~repro_torch.ckpt.checkpoint.
        FleetCheckpoint` or a directory path; returns the FleetCheckpoint.
        Queued jobs need no snapshot (nothing ran); finished jobs' results
        are not persisted (see FleetCheckpoint)."""
        from repro_torch.ckpt.checkpoint import FleetCheckpoint
        if isinstance(fleet, str):
            fleet = FleetCheckpoint(fleet)
        for j in self.jobs:
            if j.state == LIVE and j.domain is None:
                j.handle.checkpoint(fleet.manager(j.name))
        # a WorkDomain snapshots once: the composite carry, the shared
        # cursor and the merged grids; restore re-forms it from the
        # manifest before it seeks
        for d in self._domains:
            if not d.done:
                d.checkpoint(fleet.manager(self._domain_name(d)))
        fleet.wait()          # the manifest must never name a torn snapshot
        fleet.save_state({
            "policy": self.policy.name,
            "jobs": [{"name": j.name, "tenant": j.tenant,
                      "priority": j.priority, "seq": j.seq,
                      "state": j.state, "segments_run": j.segments_run,
                      "work_done": j.work_done, "wall": j.wall}
                     for j in self.jobs],
            "tenants": {t: asdict(s) for t, s in self.tenants.items()},
            "domains": [{"name": self._domain_name(d),
                         "members": list(d.names),
                         "stride": d.stride, "pack": d.pack}
                        for d in self._domains],
        })
        return fleet

    def _domain_name(self, domain) -> str:
        """A domain's snapshot name, from its first member's admission
        seq: the same after the resubmission that restore needs."""
        return f"codomain-{self._by_name[domain.names[0]].seq}"

    def restore(self, fleet) -> JobScheduler:
        """Resume a fleet snapshot (this package's or the reference's)
        into *this* scheduler: re-``submit`` the same jobs (same names,
        configs, datasets) first, then restore. Every job that was live
        at snapshot time seeks its feed to its per-job snapshot (no read
        replayed); accounting and tenant service resume where they left
        off, so fair share stays fair across the restart."""
        from repro_torch.ckpt.checkpoint import FleetCheckpoint
        if isinstance(fleet, str):
            fleet = FleetCheckpoint(fleet)
        state = fleet.load_state()
        for rec in state.get("domains", []):
            missing = [n for n in rec["members"] if n not in self._by_name]
            if missing:
                raise ValueError(
                    f"fleet snapshot domain {rec['name']!r} has members "
                    f"{missing} which were not resubmitted — restore() "
                    "re-forms domains over resubmitted jobs only")
        for rec in state["jobs"]:
            job = self._by_name.get(rec["name"])
            if job is None:
                raise ValueError(
                    f"fleet snapshot contains job {rec['name']!r} which "
                    "was not resubmitted — restore() resumes jobs, it "
                    "cannot reconstruct their configs/datasets")
            if rec["state"] in (LIVE, DONE) \
                    and fleet.has_snapshot(rec["name"]):
                job.handle.restore(fleet.manager(rec["name"]))
                self._mark_live(job)
            job.segments_run = rec["segments_run"]
            job.work_done = rec["work_done"]
            job.wall = rec["wall"]
        # re-form each domain over its resubmitted members and seek it to
        # its snapshot (members have none of their own); members the
        # saved cursor had drained finish again here, and the tenants'
        # counters come back whole below
        for rec in state.get("domains", []):
            group = [self._by_name[n] for n in rec["members"]]
            domain = self._form_domain(group, pack=rec["pack"],
                                       stride=rec["stride"])
            if fleet.has_snapshot(rec["name"]):
                domain.restore(fleet.manager(rec["name"]))
            for name in domain.collect_finished():
                j = self._by_name[name]
                j.state = DONE
                j.finished_at = time.perf_counter()
        for t, s in state.get("tenants", {}).items():
            self.tenants[t] = TenantStats(**s)
        return self
