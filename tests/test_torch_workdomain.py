"""The port's cross-job co-scheduling against the JAX package's.

``steal.fleet_merge``, ``composite_slots`` and the composite replay
(``steal_schedule(coslots=, costride=)``) equal the reference's at P in
{2, 4, 8}: every (job, task) claimed once across job boundaries, a
single-member fleet the solo schedule, priority lanes first, oversized
ids refused. At P = 1 the port's and the reference's schedulers run the
same co-scheduled fleets (``tests/test_workdomain.py``'s): records equal
to the solo runs, the short member finishing first, fair share charging
executed work, a mid-co-schedule checkpoint restored (across the
packages too), a live member's eviction refused, with equal slice states
and tenant service. The reference's cross-job stealing job does not
trace under the installed jax, so at P 4 and 8 with stealing each
member is held to its solo run and the domain's carry rows to the
composite host replay. A fleet manifest with domains round-trips
through ``FleetCheckpoint``. Tolerance 0 (integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.steal as jsteal  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.steal as steal  # noqa: E402
from repro.core.workdomain import can_coschedule as jcan  # noqa: E402
from repro_torch.ckpt import FleetCheckpoint  # noqa: E402
from repro_torch.core.registry import JobSpec, get_backend  # noqa: E402
from repro_torch.core.scheduler import DONE  # noqa: E402
from repro_torch.core.workdomain import (WorkDomain,  # noqa: E402
                                         can_coschedule, coschedule_key)
from repro_torch.data.source import FleetSource  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

VOCAB, TASK = 200, 512
STRIDE = 64                     # composite id stride of the host tests


def random_grid(rng, P, max_t=8):
    """A member grid: unique local ids < STRIDE, right-padded (the
    reference test's)."""
    T = int(rng.integers(1, max_t + 1))
    counts = rng.integers(0, T + 1, size=P)
    if counts.sum() == 0:
        counts[int(rng.integers(0, P))] = 1
    ids = -np.ones((P, T), np.int32)
    pool = rng.permutation(STRIDE)[: int(counts.sum())]
    k = 0
    for r in range(P):
        ids[r, : counts[r]] = pool[k: k + counts[r]]
        k += counts[r]
    reps = rng.integers(1, 9, size=(P, T)).astype(np.int32)
    return ids, reps


def wc_cfg(pkg=core, **kw):
    base = dict(usecase=pkg.WordCount(vocab=VOCAB), backend="1s",
                task_size=TASK, push_cap=256, n_procs=1, segment=1)
    base.update(kw)
    return pkg.JobConfig(**base)


def hist_cfg(pkg=core):
    return pkg.JobConfig(usecase=pkg.Histogram(vocab=VOCAB, n_bins=16),
                         backend="1s", task_size=TASK, push_cap=256,
                         n_procs=1, segment=1)


def sched(pkg=core, **kw):
    if pkg is core:
        return core.JobScheduler(device="cpu", **kw)
    return jcore.JobScheduler(**kw)


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, VOCAB, size=13 * TASK).astype(np.int32)


@pytest.fixture(scope="module")
def tokens_b():
    rng = np.random.default_rng(1)
    return rng.integers(0, VOCAB, size=7 * TASK).astype(np.int32)


@pytest.fixture(scope="module")
def tokens_c():
    rng = np.random.default_rng(2)
    return rng.integers(0, VOCAB, size=20 * TASK).astype(np.int32)


# ---------------------------------------------------------------------------
# the fleet cursor against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 4, 8])
def test_fleet_merge_and_replay_equal_the_reference(P):
    """Random K-member grids, priorities and initial progress: the merged
    grid, the composite slots and every field of the replay equal the
    reference's; every (job, task) pair runs once and each slot's work
    is its member's repeats."""
    rng = np.random.default_rng(P)
    for trial in range(15):
        K = int(rng.integers(2, 5))
        members = [random_grid(rng, P) for _ in range(K)]
        prios = (None if trial % 3 == 0
                 else rng.integers(0, 3, K).tolist())
        args = ([m[0] for m in members], [m[1] for m in members])
        ids, reps = steal.fleet_merge(*args, stride=STRIDE,
                                      priorities=prios)
        jids, jreps = jsteal.fleet_merge(*args, stride=STRIDE,
                                         priorities=prios)
        assert_equal(ids, jids)
        assert_equal(reps, jreps)
        assert_equal(steal.composite_slots(ids, STRIDE),
                     jsteal.composite_slots(ids, STRIDE))
        work0 = rng.integers(0, 40, size=P).astype(np.int32)
        got = steal.steal_schedule(ids, reps, work0=work0, coslots=K,
                                   costride=STRIDE)
        want = jsteal.steal_schedule(ids, reps, work0=work0, coslots=K,
                                     costride=STRIDE)
        for f in ("src_rank", "src_col", "exec_ids", "exec_reps", "work",
                  "stolen", "slot_work"):
            assert_equal(getattr(got, f), getattr(want, f), f)
        ran = got.exec_ids[got.exec_ids >= 0]
        expect = [j * STRIDE + t for j, (g, _) in enumerate(members)
                  for t in g[g >= 0].tolist()]
        assert sorted(ran.tolist()) == sorted(expect)
        for j, (g, r) in enumerate(members):
            assert got.slot_work[j] == int(r[g >= 0].sum())
        assert int(got.slot_work.sum()) == int((got.work - work0).sum())


@pytest.mark.parametrize("P", [2, 4, 8])
def test_single_member_fleet_is_the_solo_schedule(P):
    rng = np.random.default_rng(40 + P)
    for _ in range(10):
        ids, reps = random_grid(rng, P)
        fids, freps = steal.fleet_merge([ids], [reps], stride=STRIDE)
        solo = steal.steal_schedule(ids, reps)
        fleet = steal.steal_schedule(fids, freps, coslots=1,
                                     costride=STRIDE)
        assert_equal(solo.exec_ids[solo.exec_ids >= 0],
                     fleet.exec_ids[fleet.exec_ids >= 0])
        assert_equal(solo.work, fleet.work)
        assert_equal(solo.stolen, fleet.stolen)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_priority_lanes_come_first(P):
    lo = np.arange(4 * P, dtype=np.int32).reshape(P, 4)
    hi = np.arange(3 * P, dtype=np.int32).reshape(P, 3)
    ones = [np.ones_like(lo), np.ones_like(hi)]
    ids, _ = steal.fleet_merge([lo, hi], ones, stride=STRIDE,
                               priorities=[0, 7])
    assert_equal(ids, jsteal.fleet_merge([lo, hi], ones, stride=STRIDE,
                                         priorities=[0, 7])[0])
    slots = steal.composite_slots(ids, STRIDE)
    for r in range(P):
        row = slots[r][slots[r] >= 0]
        first_lo = np.argmax(row == 0)
        assert (row[:first_lo] == 1).all(), f"rank {r}: {row}"


@pytest.mark.parametrize("P", [2, 4, 8])
def test_fleet_merge_rejects_oversized_ids(P):
    ids = np.zeros((P, 2), np.int32)
    ids[0, 1] = STRIDE
    for mod in (steal, jsteal):
        with pytest.raises(AssertionError, match="stride"):
            mod.fleet_merge([ids], [np.ones_like(ids)], stride=STRIDE)


def test_fleet_source_reads_each_member_at_its_stride(tokens, tokens_b):
    """A task read through the composite plan is the member's solo task,
    sentinel-padded past its end, and a run of ids that crosses a member
    boundary reads each member's own elements."""
    from repro.core.planner import TaskPlan as JPlan
    from repro.core.planner import read_tasks as jread
    from repro.data.source import FleetSource as JFleet
    from repro_torch.core.planner import TaskPlan, read_tasks
    short = tokens_b[: 7 * TASK - 100]
    stride = 13 * TASK
    src = FleetSource([tokens, short], stride)
    assert src.len_elements() == 2 * stride
    plan = TaskPlan(n_tasks=26, task_size=TASK, n_procs=2)
    ids = np.array([[11, 12, 13, 14], [19, 20, -1, 6]], np.int32)
    got = read_tasks(src, plan, ids)
    want = jread(JFleet([tokens, short], stride),
                 JPlan(n_tasks=26, task_size=TASK, n_procs=2), ids)
    assert_equal(got, want)
    assert_equal(got[0, 2], tokens_b[:TASK])
    with pytest.raises(ValueError, match="stride"):
        FleetSource([tokens], TASK)


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------

def test_composite_specs_refused_where_the_reference_refuses():
    with pytest.raises(ValueError, match="fused_map.*coslots"):
        JobSpec(vocab=VOCAB, task_size=TASK, push_cap=256, n_procs=1,
                segment=1, fused_map=True, coslots=2, costride=STRIDE)
    spec = JobSpec(vocab=VOCAB, task_size=TASK, push_cap=256, n_procs=1,
                   segment=1, coslots=2, costride=STRIDE)
    with pytest.raises(ValueError, match="'2s'.*coslots"):
        get_backend("2s").make_segment_fns(spec, lambda *a: a[:2], "cpu")
    assert get_backend("1s").supports_coschedule
    assert not getattr(get_backend("2s"), "supports_coschedule", False)


def test_can_coschedule_gates_as_the_reference(tokens):
    cases = [wc_cfg, lambda pkg: wc_cfg(pkg, segment=0),
             lambda pkg: wc_cfg(pkg, backend="2s"),
             lambda pkg: wc_cfg(pkg, partitioner="sampled"),
             lambda pkg: wc_cfg(pkg, fused_map=True)]
    for make in cases:
        mine = core.submit(make(core), tokens, device="cpu")
        ref = jcore.submit(make(jcore), tokens)
        assert can_coschedule(mine) == jcan(ref)
        mine.close()
        ref.close()
    coded = core.submit(wc_cfg(n_procs=2, code_rate=2), tokens,
                        device="cpu")
    assert not can_coschedule(coded)          # the reference's rule
    coded.close()
    a = core.submit(wc_cfg(), tokens, device="cpu")
    b = core.submit(hist_cfg(), tokens, device="cpu")
    assert coschedule_key(a) != coschedule_key(b)
    with pytest.raises(ValueError, match="at least two"):
        WorkDomain([a])
    with pytest.raises(ValueError, match="share one program"):
        WorkDomain([a, b])
    a.step()
    with pytest.raises(ValueError, match="not co-schedulable"):
        WorkDomain([a, core.submit(wc_cfg(), tokens, device="cpu")])
    for h in (a, b):
        h.close()


# ---------------------------------------------------------------------------
# P = 1 fleets, each against the reference's scheduler
# ---------------------------------------------------------------------------

def _pair(pkg, tokens, tokens_b, **kw):
    s = sched(pkg, coschedule=True, **kw)
    s.submit(wc_cfg(pkg), tokens, tenant="t", name="a")
    s.submit(wc_cfg(pkg), tokens_b, tenant="t", name="b")
    return s


def _state(s):
    return ([(j.name, j.state, j.segments_run, j.work_done) for j in s.jobs],
            {t: (v.segments, v.work, v.jobs_done)
             for t, v in s.tenants.items()})


def test_coscheduled_jobs_equal_solo_and_the_reference(tokens, tokens_b):
    solo = [core.submit(wc_cfg(), t, device="cpu").result()
            for t in (tokens, tokens_b)]
    mine, ref = (_pair(p, tokens, tokens_b) for p in (core, jcore))
    got, want = mine.run_until_complete(), ref.run_until_complete()
    assert len(mine._domains) == 1 and mine._domains[0].done
    for name, s in zip("ab", solo):
        assert got[name].records == want[name].records == s.records
        assert got[name].output == want[name].output
        for f in ("tasks_per_rank", "work_per_rank", "steals_per_rank",
                  "keys", "values"):
            assert_equal(getattr(got[name], f), getattr(want[name], f), f)
    assert _state(mine) == _state(ref)
    assert mine["a"].work_done == 13 and mine["b"].work_done == 7
    assert mine.tenants["t"].work == 20
    assert_equal(mine._domains[0].job_work(), ref._domains[0].job_work())
    assert mine.n_unique_programs == ref.n_unique_programs == 1


def test_short_member_finishes_first_as_in_the_reference(tokens, tokens_b):
    runs = []
    for pkg in (core, jcore):
        s = _pair(pkg, tokens, tokens_b)
        states = []
        for _ in range(64):
            s.run_until_complete(max_slices=1)
            states.append(tuple(j.state for j in s.jobs))
            if all(j.state == DONE for j in s.jobs):
                break
        runs.append(states)
    assert runs[0] == runs[1]
    assert runs[0][-1] == (DONE, DONE)
    assert ("live", DONE) in runs[0]


def test_fair_share_charges_executed_work(tokens, tokens_b, tokens_c):
    out = []
    for pkg in (core, jcore):
        s = sched(pkg, policy="fair", coschedule=True)
        s.submit(wc_cfg(pkg), tokens, tenant="A", name="a1")
        s.submit(wc_cfg(pkg), tokens_b, tenant="A", name="a2")
        s.submit(hist_cfg(pkg), tokens_c, tenant="B", name="b1")
        res = s.run_until_complete()
        assert len(s._domains) == 1           # the histogram slices solo
        out.append((_state(s), {n: r.records for n, r in res.items()}))
    assert out[0] == out[1]
    (_, tenants), _ = out[0]
    assert tenants["A"][1] == tenants["B"][1] == 20


@pytest.mark.parametrize("taker,resumer", [("port", "port"),
                                           ("port", "reference"),
                                           ("reference", "port")])
def test_mid_coschedule_checkpoint_restores(tmp_path, tokens, tokens_b,
                                           taker, resumer):
    """A fleet snapshot while the shared cursor is inside the domain,
    restored into a fresh scheduler of either package: the domain
    re-forms from the manifest, both members finish with their solo
    records, the tenant's service resumes."""
    pkgs = {"port": core, "reference": jcore}
    solo = [core.submit(wc_cfg(), t, device="cpu").result().records
            for t in (tokens, tokens_b)]
    s1 = _pair(pkgs[taker], tokens, tokens_b)
    s1.run_until_complete(max_slices=1)
    assert s1._domains and not s1._domains[0].done
    s1.checkpoint(str(tmp_path))
    s1.close()
    state = FleetCheckpoint(str(tmp_path)).load_state()
    assert state["domains"] == [{"name": "codomain-0",
                                 "members": ["a", "b"], "stride": 13,
                                 "pack": 2}]
    s2 = _pair(pkgs[resumer], tokens, tokens_b)
    s2.restore(str(tmp_path))
    assert len(s2._domains) == 1
    res = s2.run_until_complete()
    assert [res["a"].records, res["b"].records] == solo
    assert s2.tenants["t"].work == 20


def test_evicting_a_live_member_raises(tokens, tokens_b):
    s = _pair(core, tokens, tokens_b)
    s.run_until_complete(max_slices=1)
    assert not s._domains[0].done
    with pytest.raises(RuntimeError, match="co-scheduled"):
        s.evict("a")
    s.run_until_complete()
    assert s.evict("a").state == DONE        # a finished domain lets go
    s.close()


def test_fleet_manifest_with_domains_round_trips(tmp_path, tokens,
                                                 tokens_b, tokens_c):
    """The manifest the port writes for a fleet with a domain and a solo
    job is the reference's for the same fleet (host seconds aside), and
    it restores into the port."""
    manifests = []
    for pkg, d in ((core, tmp_path / "port"), (jcore, tmp_path / "ref")):
        s = sched(pkg, coschedule=True, copack=1)
        s.submit(wc_cfg(pkg), tokens, tenant="A", name="a1")
        s.submit(wc_cfg(pkg), tokens_b, tenant="A", name="a2")
        s.submit(hist_cfg(pkg), tokens_c, tenant="B", name="b1")
        s.run_until_complete(max_slices=4)
        s.checkpoint(str(d))
        s.close()
        st = FleetCheckpoint(str(d)).load_state()
        for row in [*st["jobs"], *st["tenants"].values()]:
            row.pop("wall")
        manifests.append(st)
    assert manifests[0] == manifests[1]
    assert manifests[0]["domains"][0]["pack"] == 1
    s = sched(core, coschedule=True, copack=1)
    s.submit(wc_cfg(), tokens, tenant="A", name="a1")
    s.submit(wc_cfg(), tokens_b, tenant="A", name="a2")
    s.submit(hist_cfg(), tokens_c, tenant="B", name="b1")
    s.restore(str(tmp_path / "port"))
    res = s.run_until_complete()
    for name, t in (("a1", tokens), ("a2", tokens_b)):
        assert res[name].records == core.wordcount_oracle(t, VOCAB)
    assert_equal(res["b1"].output, core.histogram_oracle(tokens_c, VOCAB, 16))


# ---------------------------------------------------------------------------
# many ranks, with stealing: the host replay and the solo records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,pack", [(4, None), (8, None), (8, 1)])
def test_multirank_crossjob_stealing_equals_replay_and_solo(P, pack):
    S, V = 64, 512
    rng = np.random.default_rng(P)
    sizes = (13 * P // 4, 7 * P // 4, 3)
    data = [rng.integers(0, V, size=n * S).astype(np.int32) for n in sizes]
    reps = [np.where(rng.random((P, -(-n // P))) < 0.3, 5, 1)
            .astype(np.int32) for n in sizes]
    cfg = core.JobConfig(usecase=core.WordCount(vocab=V), backend="1s",
                         task_size=S, push_cap=128, n_procs=P, segment=1,
                         stealing=True)
    solo = [core.submit(cfg, d, repeats=r, device="cpu").result()
            for d, r in zip(data, reps)]
    hs = [core.submit(cfg, d, repeats=r, device="cpu")
          for d, r in zip(data, reps)]
    dom = WorkDomain(hs, names=["a", "b", "c"], priorities=[0, 1, 1],
                     pack=pack)
    finished = []
    while dom.step(1):
        finished += list(dom.collect_finished())
    finished += list(dom.collect_finished())
    assert dom.done and sorted(finished) == ["a", "b", "c"]
    carry = dom.handle._carry
    assert int(carry.stolen[0].sum()) > 0, "no cross-rank steals"
    for h, ref in zip(hs, solo):
        assert h.result().records == ref.records
        assert h.result().output == ref.output
    ids = dom.handle.feed.task_ids_grid
    rg = dom.handle.feed.repeats_grid
    seg = dom.handle.feed.segment
    slot_work = np.zeros((dom.K,), np.int64)
    work = np.zeros((P,), np.int32)
    stolen = 0
    for c0 in range(0, ids.shape[1], seg):
        sch = steal.steal_schedule(ids[:, c0:c0 + seg], rg[:, c0:c0 + seg],
                                   work0=work, coslots=dom.K,
                                   costride=dom.stride)
        work = sch.work
        slot_work += sch.slot_work
        stolen += sch.n_stolen
    assert_equal(slot_work, carry.job_work[0])
    assert_equal(work, carry.work[0])
    assert int(carry.stolen[0].sum()) == stolen
    assert_equal(slot_work, [int(r[g >= 0].sum()) for g, r in
                             dom._member_grids])
    assert (carry.job_work == carry.job_work[0]).all()   # replicated
