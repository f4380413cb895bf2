"""Deterministic fault injection for the elastic fleet supervisor.

Counterpart of ``repro/fleet/faults.py``: the same events for the same
seed, and the same delivery.

Chaos that cannot be replayed cannot be debugged: every fault here is a
frozen :class:`FaultEvent` on a virtual-time *tick* axis (the
supervisor's scheduling rounds, not wall seconds), and a whole campaign
is a :class:`FaultPlan` — either written out literally in a test or
derived from a seed via :meth:`FaultPlan.generate`, which uses a
counter-keyed ``np.random.default_rng`` so the same seed always yields
the same events in the same order. The :class:`FaultInjector` is the
tiny delivery mechanism: ``poll(tick)`` hands each due event to the
supervisor exactly once.

Fault kinds and what they model:

  * ``kill``       — ranks die; device state on them is lost. The
                     supervisor re-meshes the fleet onto the survivors
                     (:mod:`repro_torch.fleet.supervisor`).
  * ``join``       — ranks return; the same re-mesh path runs in
                     reverse (grow).
  * ``slow``       — a rank degrades by ``factor`` for ``duration``
                     ticks; results are unaffected, wall time is (the
                     straggler scenario the paper's decoupling targets).
  * ``feed_error`` — a job's input stream starts raising
                     :class:`InjectedIOError`; the wrapped
                     :class:`FaultingSource` delivers it through the
                     prefetch thread exactly like a real storage fault,
                     and the scheduler's failure isolation turns it into
                     a FAILED job the supervisor heals.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

KINDS = ("kill", "slow", "feed_error", "join")


class InjectedIOError(OSError):
    """The marker error a tripped :class:`FaultingSource` raises; the
    supervisor only heals jobs whose failure is this injected kind (a
    real bug in a use-case must stay FAILED, not retry forever)."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``ranks`` are mesh positions for
    ``kill``/``slow`` (a count for ``join`` would be ambiguous — it
    names the ranks being added, so only ``len(ranks)`` matters there);
    ``job`` targets ``feed_error``; ``factor`` is the slow rank's
    per-tick stall in seconds; ``duration`` is ticks (``slow``) or
    failing reads (``feed_error``)."""
    tick: int
    kind: str
    ranks: tuple[int, ...] = ()
    job: str | None = None
    factor: float = 0.0
    duration: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable chaos campaign (events sorted by tick)."""
    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.tick, e.kind))))

    @staticmethod
    def generate(seed: int, *, n_ticks: int, n_procs: int,
                 jobs: tuple[str, ...] = (), p_kill: float = 0.02,
                 p_slow: float = 0.05, p_feed: float = 0.05,
                 max_kill: int = 1) -> FaultPlan:
        """Seed-deterministic campaign: each tick independently draws
        each fault kind. Kills never take the fleet below 1 rank, and
        at most one kill event is emitted per campaign by default
        (``max_kill``) — recovery measurement wants a clean MTTR signal,
        soak tests can raise it."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        alive = n_procs
        kills = 0
        for t in range(n_ticks):
            if (kills < max_kill and alive > 1
                    and rng.random() < p_kill):
                n = int(rng.integers(1, min(2, alive - 1) + 1))
                ranks = tuple(sorted(
                    rng.choice(alive, size=n, replace=False).tolist()))
                events.append(FaultEvent(t, "kill", ranks=ranks))
                alive -= n
                kills += 1
            if rng.random() < p_slow:
                events.append(FaultEvent(
                    t, "slow", ranks=(int(rng.integers(alive)),),
                    factor=float(rng.uniform(0.001, 0.01)),
                    duration=int(rng.integers(1, 4))))
            if jobs and rng.random() < p_feed:
                events.append(FaultEvent(
                    t, "feed_error",
                    job=str(jobs[int(rng.integers(len(jobs)))]),
                    duration=int(rng.integers(1, 3))))
        return FaultPlan(tuple(events))


class FaultInjector:
    """Delivers a plan's events to the supervisor, each exactly once.

    ``poll(tick)`` returns every not-yet-delivered event with
    ``event.tick <= tick`` — late delivery (e.g. the supervisor spent
    several ticks recovering) never drops a fault, it just lands at the
    next opportunity, which is also what a real failure does."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._delivered = 0

    @property
    def pending(self) -> tuple[FaultEvent, ...]:
        return self.plan.events[self._delivered:]

    def poll(self, tick: int) -> list[FaultEvent]:
        due = [e for e in self.pending if e.tick <= tick]
        self._delivered += len(due)
        return due


@dataclass
class FaultingSource:
    """A DataSource wrapper whose reads can be tripped to raise
    :class:`InjectedIOError` — the feed-fault delivery vehicle.

    ``trip(n)`` arms the next ``n`` reads; the failure surfaces wherever
    the read actually happens (usually the SegmentFeed's prefetch
    thread, whose Future re-raises at ``next_segment``) — the same
    propagation path a real storage error takes. Reads stay pure:
    a failed read consumed no stream state, so a healed job re-reads
    the same offsets and gets the same bytes."""
    inner: object
    name: str = ""
    _armed: int = 0
    _fired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def trip(self, n_reads: int = 1):
        with self._lock:
            self._armed += int(n_reads)

    @property
    def faults_fired(self) -> int:
        return self._fired

    def len_elements(self) -> int:
        return self.inner.len_elements()

    def read(self, offset: int, size: int) -> np.ndarray:
        with self._lock:
            if self._armed > 0:
                self._armed -= 1
                self._fired += 1
                raise InjectedIOError(
                    f"injected I/O fault on source {self.name!r} "
                    f"(read offset={offset}, size={size})")
        return self.inner.read(offset, size)
