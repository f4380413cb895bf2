"""The elastic fleet supervisor: keep a JobScheduler fleet live through
rank loss, stragglers, and I/O faults — re-meshing instead of restarting.

Counterpart of ``repro/fleet/supervisor.py``, with ``device=`` in place
of the reference's mesh: a re-mesh builds a fresh
:class:`~repro_torch.core.scheduler.JobScheduler` at the new rank count
(a scheduler pins one rank count) on the same device.

The paper decouples processes so an imbalanced workload cannot serialize
a fleet; this module applies the same stance to *failures*: losing ranks
must not mean losing the fleet. The supervisor owns the durable pieces —
job registry, collected results, the :class:`FleetCheckpoint` — and
treats the scheduler and its rank count as disposable:

    sup = FleetSupervisor(n_procs=8, ckpt_dir=..., plan=chaos,
                          device="cpu")
    sup.submit(cfg, corpus, name="wc0", tenant="batch")
    ...
    results = sup.run()          # survives whatever `chaos` throws at it

Each ``run`` tick: deliver due faults (:class:`FaultInjector`), stall
for active slow-rank penalties, drive the scheduler a few slices,
collect finished results, heal injected-I/O failures, and periodically
checkpoint the fleet (async — the storage-windows trick, so the ticks
keep flowing while snapshots drain).

Recovery model (kill): device state on dead ranks is gone, so the whole
scheduler is dropped — feeds closed, in-memory carries abandoned — and
the fleet is rebuilt at P_new = survivors from the last durable
snapshot: every uncollected job is resubmitted at P_new and
elastic-restored (:func:`repro_torch.fleet.remesh.elastic_restore` —
windows folded, tasks re-bucketized, checksum-verified) or restarted from
scratch if it was never snapshotted. Re-executing the
since-last-snapshot suffix IS the recovery cost the fig13 benchmark
measures; results already collected are host data and survive in
memory. A ``join`` runs the same path in reverse (checkpoint first —
the state is still alive — then grow onto P + new ranks; the fold with
n_new > P_old leaves the new ranks' windows zero).

Heal (feed_error): the failed job is evicted (the duplicate-name guard
exists so two live jobs never share a snapshot dir — eviction frees the
name), resubmitted at the current P, and elastic-restored from its own
snapshot; a bounded retry budget keeps a genuinely broken job from
spinning. Only :class:`InjectedIOError` failures heal — a real bug in a
use-case stays FAILED and lands in :attr:`FleetSupervisor.failed`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from collections.abc import Callable
from dataclasses import dataclass

from repro_torch.ckpt.checkpoint import FleetCheckpoint
from repro_torch.core.scheduler import (DONE, FAILED, JobScheduler,
                                        TenantStats)
from repro_torch.data.source import as_source
from repro_torch.device import resolve_device
from repro_torch.fleet.faults import (FaultInjector, FaultPlan,
                                      FaultingSource, InjectedIOError)
from repro_torch.fleet.remesh import elastic_restore
from repro_torch.ft.elastic import remesh_fleet


@dataclass
class FleetEntry:
    """One registered job — everything needed to resubmit it onto a new
    mesh (the scheduler's admission record dies with the mesh; this one
    belongs to the supervisor)."""
    name: str
    config: object                   # JobConfig; n_procs re-derived per mesh
    source: FaultingSource
    tenant: str = "default"
    priority: int = 0
    on_slice: Callable | None = None


@dataclass
class RecoveryRecord:
    """One re-mesh, as measured — the rows of fig13's MTTR table."""
    tick: int
    kind: str                        # "kill" | "join"
    p_old: int
    p_new: int
    seconds: float                   # wall time of the re-mesh itself
    jobs_restored: int               # elastic-restored from snapshots
    jobs_scratch: int                # never snapshotted: restarted


@dataclass
class _SlowState:
    factor: float
    remaining: int


class FleetSupervisor:
    """Run a fleet of jobs under fault injection; see module docstring.

    Parameters
    ----------
    n_procs:        initial rank count (1-D ``("procs",)``).
    ckpt_dir:       FleetCheckpoint root — the durable recovery state.
    plan:           :class:`FaultPlan` to inject (default: no faults,
                    i.e. a plain supervised run).
    policy:         scheduler policy for every (re)built scheduler.
    ckpt_every:     fleet checkpoint period in ticks (0 disables — then
                    a kill restarts every job from scratch).
    slices_per_tick: scheduler slices driven per tick; smaller = finer
                    fault-delivery granularity, more checkpoints.
    heal_retries:   per-job budget for healing injected I/O failures.
    max_live_bytes: forwarded to every scheduler (shared feed budget).
    device:         where every job runs (cuda unless given).
    restore_on_remesh: when False, a re-mesh ignores existing snapshots
                    and restarts every job from scratch — the
                    restart-discipline control arm of the fig13
                    benchmark (same checkpoint cadence, snapshots
                    unused at recovery). Healing feed faults still
                    restores: that path never changes the mesh.
    """

    def __init__(self, *, n_procs: int, ckpt_dir: str,
                 plan: FaultPlan | None = None, policy: str = "fair",
                 ckpt_every: int = 2, slices_per_tick: int = 4,
                 heal_retries: int = 2,
                 max_live_bytes: int | None = None,
                 restore_on_remesh: bool = True, device=None):
        self.n_procs = int(n_procs)
        self.device = resolve_device(device)
        self.fleet = FleetCheckpoint(ckpt_dir)
        self.injector = FaultInjector(plan or FaultPlan())
        self.policy = policy
        self.ckpt_every = int(ckpt_every)
        self.slices_per_tick = int(slices_per_tick)
        self.heal_retries = int(heal_retries)
        self.max_live_bytes = max_live_bytes
        self.restore_on_remesh = bool(restore_on_remesh)
        self.entries: dict[str, FleetEntry] = {}
        self.results: dict = {}              # name -> JobResult
        self.failed: dict = {}               # name -> exception (terminal)
        self.recoveries: list[RecoveryRecord] = []
        self.timeline: list[dict] = []       # (tick, kind, detail) log
        self.ticks_run = 0
        self._sched: JobScheduler | None = None
        self._slow: list[_SlowState] = []
        self._heals: dict[str, int] = defaultdict(int)

    # -- registry ------------------------------------------------------------

    def submit(self, config, dataset, *, name: str,
               tenant: str = "default", priority: int = 0,
               on_slice: Callable | None = None) -> FleetEntry:
        """Register a job and admit it to the live scheduler. The
        dataset is wrapped in a :class:`FaultingSource` (reads stay
        pure, so resubmissions after a fault re-read identical bytes);
        the wrapper persists across re-meshes — it IS the durable
        dataset identity."""
        if name in self.entries:
            raise ValueError(f"duplicate fleet job name {name!r}")
        entry = FleetEntry(
            name=name, config=config,
            source=(dataset if isinstance(dataset, FaultingSource)
                    else FaultingSource(as_source(dataset), name=name)),
            tenant=tenant, priority=priority, on_slice=on_slice)
        self.entries[name] = entry
        self._admit(self._ensure_sched(), entry)
        return entry

    def _new_sched(self) -> JobScheduler:
        """A scheduler at the current rank count (``remesh_fleet``
        validates it): one per layout, as the reference makes one mesh."""
        remesh_fleet(self.n_procs)
        return JobScheduler(policy=self.policy, device=self.device,
                            max_live_bytes=self.max_live_bytes)

    def _ensure_sched(self) -> JobScheduler:
        if self._sched is None:
            self._sched = self._new_sched()
        return self._sched

    def _admit(self, sched: JobScheduler, entry: FleetEntry):
        cfg = dataclasses.replace(entry.config, n_procs=self.n_procs)
        return sched.submit(cfg, entry.source, name=entry.name,
                            tenant=entry.tenant, priority=entry.priority,
                            on_slice=entry.on_slice)

    # -- introspection -------------------------------------------------------

    @property
    def done(self) -> bool:
        settled = set(self.results) | set(self.failed)
        return settled >= set(self.entries)

    @property
    def scheduler(self) -> JobScheduler | None:
        """The CURRENT scheduler — replaced wholesale by a re-mesh, so
        hold the supervisor, not this."""
        return self._sched

    def stats(self) -> dict:
        return {
            "n_procs": self.n_procs,
            "ticks_run": self.ticks_run,
            "results": sorted(self.results),
            "failed": sorted(self.failed),
            "recoveries": [dataclasses.asdict(r)
                           for r in self.recoveries],
            "timeline": list(self.timeline),
        }

    # -- the tick loop -------------------------------------------------------

    def run(self, max_ticks: int = 10_000) -> dict:
        """Drive the fleet to completion (or ``max_ticks``) under the
        fault plan; returns ``{name: JobResult}`` for every job that
        finished. Terminal failures are in :attr:`failed`, never raised
        — one broken tenant must not take the supervisor down with it."""
        self._ensure_sched()
        tick = self.ticks_run
        end = tick + int(max_ticks)
        while tick < end and not self.done:
            for ev in self.injector.poll(tick):
                self._apply(ev, tick)
            self._stall()
            self._sched.run_until_complete(
                max_slices=self.slices_per_tick)
            self._collect()
            self._heal(tick)
            if (self.ckpt_every and not self.done
                    and tick % self.ckpt_every == self.ckpt_every - 1):
                self._sched.checkpoint(self.fleet)
            tick += 1
            self.ticks_run = tick
        return dict(self.results)

    def _collect(self):
        for j in list(self._sched.jobs):
            if j.state == DONE and j.name not in self.results:
                self.results[j.name] = j.handle.result()

    # -- fault application ---------------------------------------------------

    def _apply(self, ev, tick: int):
        if ev.kind == "kill":
            dead = [r for r in ev.ranks if r < self.n_procs]
            self._log(tick, "kill", ranks=list(dead))
            self._remesh(max(1, self.n_procs - len(dead)), tick, "kill")
        elif ev.kind == "join":
            self._log(tick, "join", ranks=list(ev.ranks))
            self._remesh(self.n_procs + len(ev.ranks), tick, "join")
        elif ev.kind == "slow":
            self._log(tick, "slow", ranks=list(ev.ranks),
                      factor=ev.factor, duration=ev.duration)
            self._slow.append(_SlowState(ev.factor * len(ev.ranks),
                                         ev.duration))
        elif ev.kind == "feed_error":
            entry = self.entries.get(ev.job or "")
            if entry is not None and entry.name not in self.results:
                self._log(tick, "feed_error", job=entry.name,
                          reads=ev.duration)
                entry.source.trip(ev.duration)

    def _stall(self):
        """Serve active slow-rank penalties: the decoupled engines keep
        other ranks' *results* independent, but one mesh means one
        program — a straggling rank stretches every tick's wall time
        (which is exactly what fig13's slow scenario measures)."""
        for s in self._slow:
            time.sleep(s.factor)
            s.remaining -= 1
        self._slow = [s for s in self._slow if s.remaining > 0]

    # -- re-mesh -------------------------------------------------------------

    def _remesh(self, p_new: int, tick: int, kind: str):
        t0 = time.perf_counter()
        p_old = self.n_procs
        old = self._sched
        if kind == "join" and old is not None and self.ckpt_every:
            # growing: nothing died, so snapshot the live state first —
            # the grow then loses no work at all
            old.checkpoint(self.fleet)
        if old is not None:
            old.close()          # feeds stop; in-memory carries are gone
        self.n_procs = int(p_new)
        sched = self._new_sched()
        restored = scratch = 0
        for name, entry in self.entries.items():
            if name in self.results or name in self.failed:
                continue         # already settled: host data, survives
            handle = self._admit(sched, entry)
            if self.restore_on_remesh and self.fleet.has_snapshot(name):
                elastic_restore(handle, self.fleet.manager(name))
                restored += 1
            else:
                scratch += 1
        if self.fleet.has_state():
            # fair share stays fair across the re-mesh: resume tenant
            # service accounting from the last committed fleet manifest
            state = self.fleet.load_state()
            for t, s in state.get("tenants", {}).items():
                sched.tenants[t] = TenantStats(**s)
        self._sched = sched
        self.recoveries.append(RecoveryRecord(
            tick=tick, kind=kind, p_old=p_old, p_new=self.n_procs,
            seconds=time.perf_counter() - t0,
            jobs_restored=restored, jobs_scratch=scratch))

    # -- heal (feed faults) --------------------------------------------------

    def _heal(self, tick: int):
        for j in [j for j in self._sched.jobs if j.state == FAILED]:
            name = j.name
            healable = (isinstance(j.error, InjectedIOError)
                        and self._heals[name] < self.heal_retries)
            self._sched.evict(name)
            if not healable:
                self.failed[name] = j.error
                self._log(tick, "job_failed", job=name,
                          error=repr(j.error))
                continue
            self._heals[name] += 1
            handle = self._admit(self._sched, self.entries[name])
            if self.fleet.has_snapshot(name):
                elastic_restore(handle, self.fleet.manager(name))
            self._log(tick, "healed", job=name,
                      attempt=self._heals[name])

    def _log(self, tick: int, kind: str, **detail):
        self.timeline.append({"tick": tick, "wall": time.perf_counter(),
                              "kind": kind, "p": self.n_procs, **detail})

    # -- teardown ------------------------------------------------------------

    def close(self):
        if self._sched is not None:
            self._sched.close()

    def __enter__(self) -> FleetSupervisor:
        return self

    def __exit__(self, *exc):
        self.close()
        return False
