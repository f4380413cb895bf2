"""The port's multi-tenant JobScheduler and FeedBudget, against the JAX package.

``repro_torch.core.scheduler`` on ``device="cpu"``: each test of
``tests/test_scheduler.py`` has a counterpart here (exactness under
interleaving, policy order, tenant accounting, one program a use-case,
failure isolation, backpressure, the shared FeedBudget, ready/prime, the
re-planning hook). Then the port's scheduler is held to the reference's
own on one seeded fleet of unfused jobs (``torch_parity.fleet_jobs``),
at P = 1 in process and at P = 8 in one 8-device JAX subprocess: every
job's result, the tenant totals, ``stats()`` apart from host seconds,
and under ``fifo`` and ``priority`` (deterministic) the slice order and
every feed's and the budget's denials. ``fair`` prefers a job whose
prefetch has landed, which depends on timing in either package, so its
order and denials are not compared. ``FeedBudget`` is held to the
reference's on scripted reserve/release sequences. The fleet
checkpoint's tests are in ``tests/test_torch_fleet_ckpt.py``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.data.feed import FeedBudget as JBudget  # noqa: E402
from repro_torch.core import (AdmissionQueueFull, JobConfig,  # noqa: E402
                              JobScheduler, available_policies,
                              resolve_policy, submit)
from repro_torch.core.scheduler import DONE, FAILED  # noqa: E402
from repro_torch.core.usecases import (Histogram, WordCount,  # noqa: E402
                                       histogram_oracle, wordcount_oracle)
from repro_torch.data.feed import FeedBudget  # noqa: E402
from torch_parity import (assert_same_result, result_summary,  # noqa: E402
                          run_fleet)

VOCAB, N, TASK = 200, 8192, 512
POLICIES = ("fifo", "fair", "priority")


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, VOCAB, size=N).astype(np.int32)


def wc_cfg(**kw):
    base = dict(usecase=WordCount(vocab=VOCAB), backend="1s",
                task_size=TASK, push_cap=256, n_procs=1, segment=2)
    base.update(kw)
    return JobConfig(**base)


def cpu_sched(**kw):
    return JobScheduler(device="cpu", **kw)


@dataclasses.dataclass(frozen=True)
class Boom:
    """Its map raises: the poisoned tenant."""
    vocab: int

    @property
    def window(self):
        return self.vocab

    def map_emit(self, toks, task_id):
        raise ValueError("boom in the map")


# ---------------------------------------------------------------------------
# policies / admission
# ---------------------------------------------------------------------------

def test_policy_registry():
    assert available_policies() == ["fair", "fifo", "priority"]
    assert resolve_policy("fifo").name == "fifo"
    with pytest.raises(ValueError, match="nope.*fair"):
        resolve_policy("nope")
    with pytest.raises(TypeError):
        resolve_policy(42)


def test_submit_requires_segmented(tokens):
    with pytest.raises(ValueError, match="segment"):
        cpu_sched().submit(wc_cfg(segment=0), tokens)


def test_one_device_many_tenants(tokens):
    sched = cpu_sched()
    sched.submit(wc_cfg(), tokens)
    with pytest.raises(ValueError, match="ONE device"):
        sched.submit(wc_cfg(n_procs=2), tokens)
    assert all(j.handle.device == torch.device("cpu") for j in sched.jobs)


def test_duplicate_name_rejected(tokens):
    sched = cpu_sched()
    sched.submit(wc_cfg(), tokens, name="a")
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit(wc_cfg(), tokens, name="a")


def test_admission_backpressure(tokens):
    sched = cpu_sched(max_pending=2)
    sched.submit(wc_cfg(), tokens)
    sched.submit(wc_cfg(), tokens)
    with pytest.raises(AdmissionQueueFull, match="max_pending=2"):
        sched.submit(wc_cfg(), tokens)
    sched.run_until_complete()
    sched.submit(wc_cfg(), tokens)          # open slots again
    assert len(sched.run_until_complete()) == 3


@pytest.mark.parametrize("kw", [{"coschedule": True}, {"copack": 4}])
def test_coschedule_raises_naming_item_10(kw, tokens):
    """Item 10 is ported: the options no longer raise; ``coschedule``
    merges two WordCount jobs into one domain, and ``copack`` alone forms
    none (tests/test_torch_workdomain.py holds the domains)."""
    sched = cpu_sched(**kw)
    assert sched.coschedule == kw.get("coschedule", False)
    assert sched.copack == kw.get("copack")
    sched.submit(wc_cfg(), tokens, name="a")
    sched.submit(wc_cfg(), tokens[: N // 2], name="b")
    res = sched.run_until_complete()
    assert len(sched._domains) == int(sched.coschedule)
    assert res["a"].records == wordcount_oracle(tokens, VOCAB)


# ---------------------------------------------------------------------------
# exactness + accounting under interleaving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_interleaved_results_equal_solo(tokens, policy):
    half = tokens[: N // 2]
    hist_cfg = JobConfig(usecase=Histogram(vocab=VOCAB, n_bins=16),
                         backend="1s", task_size=TASK, push_cap=256,
                         n_procs=1, segment=2)
    sched = cpu_sched(policy=policy)
    sched.submit(wc_cfg(), tokens, name="wc", tenant="a")
    sched.submit(hist_cfg, half, name="hist", tenant="b", priority=1)
    res = sched.run_until_complete()
    assert res["wc"].records == wordcount_oracle(tokens, VOCAB)
    np.testing.assert_array_equal(res["hist"].output,
                                  histogram_oracle(half, VOCAB, 16))
    assert sched["wc"].handle.result() is res["wc"]


def test_tenant_accounting(tokens):
    sched = cpu_sched(policy="fair")
    sched.submit(wc_cfg(), tokens, name="a1", tenant="a")
    sched.submit(wc_cfg(), tokens, name="a2", tenant="a")
    sched.submit(wc_cfg(), tokens[: N // 2], name="b", tenant="b")
    sched.run_until_complete()
    n_tasks, half_tasks = N // TASK, N // 2 // TASK
    assert sched.tenants["a"].work == 2 * n_tasks
    assert sched.tenants["b"].work == half_tasks
    assert sched.tenants["a"].segments == 2 * ((n_tasks + 1) // 2)
    assert sched.tenants["a"].jobs_done == 2
    assert sched.tenants["b"].jobs_done == 1
    assert sched.tenants["a"].wall > 0
    st = sched.stats()
    assert set(st) == {"policy", "n_unique_programs", "budget_live_bytes",
                       "tenants", "jobs"}
    assert {j["name"] for j in st["jobs"]} == {"a1", "a2", "b"}
    assert all(j["state"] == DONE for j in st["jobs"])
    for name in ("a1", "a2", "b"):
        assert sched.latency(name) > 0


def test_fair_share_finishes_small_tenant_first(tokens):
    big, small = tokens, tokens[: 2 * TASK]

    def run(policy):
        sched = cpu_sched(policy=policy, slice_segments=1)
        sched.submit(wc_cfg(segment=1), big, name="big", tenant="batch")
        sched.submit(wc_cfg(segment=1), small, name="small",
                     tenant="interactive")
        sched.run_until_complete()
        return sched.latency("small"), sched.latency("big")

    fifo_small, fifo_big = run("fifo")
    fair_small, fair_big = run("fair")
    assert fifo_small > fifo_big
    assert fair_small < fair_big
    assert fair_small < fifo_small


def test_priority_policy_orders_classes(tokens):
    sched = cpu_sched(policy="priority", slice_segments=1)
    sched.submit(wc_cfg(segment=1), tokens, name="low", priority=0)
    sched.submit(wc_cfg(segment=1), tokens, name="high", priority=5)
    sched.run_until_complete()
    assert sched.latency("high") < sched.latency("low")


def test_run_until_complete_is_resumable(tokens):
    sched = cpu_sched(policy="fifo")
    sched.submit(wc_cfg(), tokens, name="a")
    partial = sched.run_until_complete(max_slices=2)
    assert partial == {} and sched["a"].state == "live"
    res = sched.run_until_complete()
    assert res["a"].records == wordcount_oracle(tokens, VOCAB)


# ---------------------------------------------------------------------------
# duplicate submits share one program (and each keeps its own engine)
# ---------------------------------------------------------------------------

def test_duplicate_submits_share_one_program_and_keep_their_engines(tokens):
    """K submits of one JobConfig are one program: one memoized map_fn.
    Unlike the reference's, each handle keeps its own engine (its graphs
    write its own carry)."""
    sched = cpu_sched(policy="fair")
    handles = [sched.submit(wc_cfg(), tokens, name=f"j{i}",
                            tenant=f"t{i}") for i in range(4)]
    res = sched.run_until_complete()
    assert sched.n_unique_programs == 1
    assert len({id(h._map_fn) for h in handles}) == 1
    assert len({id(h._seg_fns) for h in handles}) == 4
    oracle = wordcount_oracle(tokens, VOCAB)
    for i in range(4):
        assert res[f"j{i}"].records == oracle
    hist_cfg = JobConfig(usecase=Histogram(vocab=VOCAB, n_bins=16),
                         backend="1s", task_size=TASK, push_cap=256,
                         n_procs=1, segment=2)
    sched.submit(hist_cfg, tokens, name="hist")
    sched.run_until_complete()
    assert sched.n_unique_programs == 2


def test_as_map_fn_is_memoized_for_hashable_usecases():
    assert core.as_map_fn(WordCount(VOCAB)) is core.as_map_fn(
        WordCount(VOCAB))
    assert core.as_map_fn(WordCount(VOCAB)) is not core.as_map_fn(
        WordCount(VOCAB + 1))

    class Unhashable(WordCount):
        __hash__ = None

    uc = Unhashable(VOCAB)
    assert core.as_map_fn(uc) is not core.as_map_fn(uc)


# ---------------------------------------------------------------------------
# failure isolation
# ---------------------------------------------------------------------------

def test_raising_job_closes_feed_without_stalling_siblings(tokens):
    sched = cpu_sched(policy="fair")
    bad_cfg = JobConfig(usecase=Boom(vocab=VOCAB), backend="1s",
                        task_size=TASK, push_cap=256, n_procs=1, segment=2)
    hb = sched.submit(bad_cfg, tokens, name="bad", tenant="evil")
    hg1 = sched.submit(wc_cfg(), tokens, name="good1")
    hg2 = sched.submit(wc_cfg(), tokens[: N // 2], name="good2")
    res = sched.run_until_complete()
    assert sched["bad"].state == FAILED
    assert isinstance(sched["bad"].error, ValueError)
    assert hb.feed._closed
    assert sched.tenants["evil"].jobs_failed == 1
    assert set(res) == {"good1", "good2"}
    assert res["good1"].records == wordcount_oracle(tokens, VOCAB)
    assert res["good2"].records == wordcount_oracle(tokens[: N // 2], VOCAB)
    assert hg1.feed._closed and hg2.feed._closed


def test_raise_on_error_fails_fast(tokens):
    sched = cpu_sched(policy="fifo")
    bad_cfg = JobConfig(usecase=Boom(vocab=VOCAB), backend="1s",
                        task_size=TASK, push_cap=256, n_procs=1, segment=2)
    hb = sched.submit(bad_cfg, tokens, name="bad")
    with pytest.raises(ValueError, match="boom"):
        sched.run_until_complete(raise_on_error=True)
    assert hb.feed._closed


# ---------------------------------------------------------------------------
# the shared FeedBudget
# ---------------------------------------------------------------------------

def test_feed_budget_arbitrates_prefetch(tokens):
    sched = cpu_sched(policy="fair", max_live_bytes=TASK * 4 * 2)
    for i in range(4):
        sched.submit(wc_cfg(segment=1), tokens, name=f"j{i}",
                     tenant=f"t{i}")
    res = sched.run_until_complete()
    oracle = wordcount_oracle(tokens, VOCAB)
    for i in range(4):
        assert res[f"j{i}"].records == oracle
    denials = sum(j.handle.feed.stats.budget_denials for j in sched.jobs)
    assert denials > 0
    assert sched.budget.live_bytes == 0
    assert sched.budget.denials == denials


def test_feed_budget_always_grants_when_idle():
    b = FeedBudget(10)
    assert b.try_reserve("a", 100)
    assert not b.try_reserve("b", 1)
    b.release("a")
    assert b.try_reserve("b", 1)
    b.release("b")
    assert b.live_bytes == 0
    with pytest.raises(ValueError, match="positive"):
        FeedBudget(0)


@pytest.mark.parametrize("seed", range(4))
def test_feed_budget_equals_the_reference_on_a_script(seed):
    """The same seeded sequence of reserve and release calls (repeated
    keys, releases of keys never held) on both packages' budgets: every
    answer, ``live_bytes`` and ``denials`` equal after each call."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(50, 400))
    mine, ref = FeedBudget(cap), JBudget(cap)
    for _ in range(200):
        key = ("feed", int(rng.integers(0, 6)))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 160))
            assert mine.try_reserve(key, n) == ref.try_reserve(key, n)
        else:
            mine.release(key)
            ref.release(key)
        assert (mine.live_bytes, mine.denials) == (ref.live_bytes,
                                                   ref.denials)
    assert mine.denials > 0


def test_feed_budget_under_racing_threads():
    """More threads than cores reserving and releasing under a short
    switch interval: every denial counted once, every reservation given
    back, and a granted reservation never pushes the held bytes past the
    budget unless it is the only one held."""
    import sys
    import threading
    budget, denied, over = FeedBudget(64), [0] * 16, []

    def work(i):
        for r in range(400):
            key = (i, r)
            if budget.try_reserve(key, 16):
                with budget._lock:
                    held = dict(budget._held)
                if len(held) > 1 and sum(held.values()) > 64:
                    over.append(held)
                budget.release(key)
            else:
                denied[i] += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert budget.live_bytes == 0 and not over
    assert budget.denials == sum(denied)


def test_ready_and_prime(tokens):
    h = submit(wc_cfg(segment=1), tokens, device="cpu")
    assert not h.ready()
    h.feed.prime()
    h.feed._pending[1].result()          # wait for the background read
    assert h.ready()
    assert h.cursor == 0                 # ready()/prime() consumed nothing
    assert h.result().records == wordcount_oracle(tokens, VOCAB)
    assert h.ready()                     # done handles are always ready


def test_queued_jobs_feeds_pin_nothing(tokens):
    """Jobs submitted for the card make no pinned pair and no stream at
    submit: a job that ``max_active`` keeps queued holds neither (the
    pair is made at the feed's first build on the card). Nothing runs,
    so no card is needed. On the CPU, a fleet run part way leaves the
    queued jobs' feeds unbuilt."""
    sched = JobScheduler(device="cuda", max_active=1)
    for i in range(3):
        sched.submit(wc_cfg(), tokens, name=f"j{i}")
    for j in sched.jobs:
        feed = j.handle.feed
        assert feed.device.type == "cuda"
        assert feed._pinned is None and feed._stream is None
    cpu = cpu_sched(policy="fifo", max_active=1)
    for i in range(3):
        cpu.submit(wc_cfg(), tokens, name=f"j{i}")
    cpu.run_until_complete(max_slices=3)
    assert [j.state for j in cpu.jobs] == ["live", "queued", "queued"]
    for j in cpu.jobs[1:]:
        assert j.handle.feed.stats.segments_built == 0
        assert j.handle.feed._pinned is None


def test_rebalance_hook_between_slices(tokens):
    from repro_torch.ft.straggler import rebalance_hook
    calls = []
    inner = rebalance_hook(drift_threshold=1.0)   # always past threshold

    def hook(handle, slice_stats):
        calls.append(slice_stats.segments)
        return inner(handle, slice_stats)

    sched = cpu_sched(policy="fifo")
    sched.submit(wc_cfg(), tokens, name="a", on_slice=hook)
    res = sched.run_until_complete()
    assert res["a"].records == wordcount_oracle(tokens, VOCAB)
    assert len(calls) >= 2 and all(c == 1 for c in calls)


def test_rebalance_hook_replans_as_the_reference_does(tokens):
    """The port's hook and the reference's (plain numpy over a handle's
    methods, so it drives the port's handle too), each the ``on_slice``
    hook of a port scheduler over the same skewed P = 4 job, with each
    slice's seconds fixed: the same grids after every slice, and exact
    records."""
    from repro.ft.straggler import rebalance_hook as jhook
    from repro_torch.ft.straggler import rebalance_hook as hook
    P, task = 4, TASK // 4
    T = -(-N // task) // P
    reps = (1 + np.arange(P * T) % 4).reshape(P, T)
    reps[0] *= 3                           # rank 0 does the most work
    grids = {}
    for name, make in (("port", hook), ("ref", jhook)):
        inner, seen = make(drift_threshold=1.0), []

        def on_slice(handle, st, inner=inner, seen=seen):
            st.seconds = 1.0 + 0.25 * len(seen)
            inner(handle, st)
            seen.append(np.array(handle.feed.task_ids_grid))

        sched = cpu_sched(policy="fifo")
        sched.submit(wc_cfg(task_size=task, n_procs=P), tokens, name="a",
                     on_slice=on_slice, repeats=reps)
        res = sched.run_until_complete()
        assert res["a"].records == wordcount_oracle(tokens, VOCAB)
        grids[name] = seen
    assert len(grids["port"]) == len(grids["ref"]) >= 2
    assert any(g.shape != grids["port"][0].shape or (g != grids["port"][0])
               .any() for g in grids["port"][1:])
    for a, b in zip(grids["port"], grids["ref"], strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port's scheduler against the reference's, on one seeded fleet
# ---------------------------------------------------------------------------

FLEET_P8_TASK = 64


@pytest.fixture(scope="module")
def fleet_data():
    rng = np.random.default_rng(1)
    return (rng.zipf(1.4, N) % 300).astype(np.int32)


def _assert_fleets_equal(mine: dict, ref: dict, policy: str):
    assert mine["results"].keys() == ref["results"].keys()
    for name in ref["results"]:
        assert json.dumps(mine["results"][name]) == json.dumps(
            ref["results"][name]), name
    assert mine["stats"] == ref["stats"]
    assert mine["n_unique_programs"] == ref["n_unique_programs"] == 3
    if policy != "fair":
        assert mine["order"] == ref["order"]
        assert mine["denials"] == ref["denials"]
        assert mine["budget_denials"] == ref["budget_denials"]
        assert mine["budget_denials"] == sum(mine["denials"].values()) > 0


@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_equals_the_reference_at_p1(fleet_data, policy):
    mine = run_fleet(core, policy, fleet_data, 1, TASK, device="cpu")
    ref = run_fleet(jcore, policy, fleet_data, 1, TASK)
    _assert_fleets_equal(mine, ref, policy)


def test_fleet_results_are_job_results_of_both_packages(fleet_data):
    """The summaries compared above are ``assert_same_result``'s fields:
    a solo job of each package, summarized, compares as it does."""
    cfg = dict(usecase=None, task_size=TASK, push_cap=256, n_procs=1,
               segment=2)
    mine = core.submit(core.JobConfig(**{**cfg, "usecase": core.WordCount(
        300)}), fleet_data, device="cpu").result()
    ref = jcore.submit(jcore.JobConfig(**{**cfg, "usecase": jcore.WordCount(
        300)}), fleet_data).result()
    assert_same_result(mine, ref)
    assert json.dumps(result_summary(mine)) == json.dumps(
        result_summary(ref))


@pytest.fixture(scope="module")
def reference_fleets_p8(devices8, fleet_data, tmp_path_factory):
    """The reference's scheduler over the seeded fleet at P = 8 under
    each policy, in one 8-device JAX subprocess."""
    d = tmp_path_factory.mktemp("fleet_p8")
    np.save(d / "data.npy", fleet_data)
    devices8(f"""
        import json, sys
        import numpy as np
        sys.path.insert(0, {str(__import__("torch_parity").REPO)!r}
                        + "/tests")
        import repro.core as core
        from torch_parity import run_fleet
        data = np.load({str(d / "data.npy")!r})
        out = {{p: run_fleet(core, p, data, 8, {FLEET_P8_TASK})
                for p in {POLICIES!r}}}
        with open({str(d / "out.json")!r}, "w") as f:
            json.dump(out, f)
        print("OK")
    """)
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("policy", POLICIES)
def test_scheduler_equals_the_reference_at_p8(reference_fleets_p8,
                                              fleet_data, policy):
    mine = run_fleet(core, policy, fleet_data, 8, FLEET_P8_TASK,
                     device="cpu")
    ref = reference_fleets_p8[policy]
    # JSON turned the reference's (key, value) pairs into lists
    mine = json.loads(json.dumps(mine))
    _assert_fleets_equal(mine, ref, policy)
