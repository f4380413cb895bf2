"""The PyTorch port's Job API against the use-case oracles and JAX.

``repro_torch.core.submit`` on ``device="cpu"``: records equal to the
numpy oracles at P in {1, 2, 4, 8}, oneshot and segmented, random
repeats, fused on and off; records, JobResult stats and per-rank
windows equal to the JAX package's (P = 1 in this process, P = 8 in one
8-device subprocess for the module); a JAX carry loaded through
``carry_from_numpy`` finishes with JAX's records; every option outside
the port so far raises NotImplementedError (the coded shuffle,
co-scheduling and ``elastic_load``, ported since, no longer do), and
those ported since (stealing, the sampled partitioners, a feed budget)
run. MR-2S and checkpoint, restore and re-planning have their own files
(``test_torch_twosided``, ``test_torch_ckpt``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import onesided, windows  # noqa: E402
from repro_torch.core.kv import KEY_SENTINEL  # noqa: E402
from repro_torch.core.planner import gather_segment  # noqa: E402
from repro_torch.core.planner import plan_input, shard_task_ids  # noqa: E402
from repro_torch.data.feed import SegmentFeed  # noqa: E402
from repro_torch.data.source import ArraySource  # noqa: E402
from torch_parity import STATS as _STATS  # noqa: E402
from torch_parity import USECASES, assert_equal  # noqa: E402
from torch_parity import usecase as _usecase  # noqa: E402
from torch_parity import (  # noqa: E402
    assert_same_result as _assert_same_result)

VOCAB, N, TASK, CAP = 300, 8192, 64, 8
@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.zipf(1.4, N) % VOCAB).astype(np.int32)


def _reps(P, seed=1):
    T = -(-(-(-N // TASK)) // P)
    return np.random.default_rng(seed + P).integers(1, 4, (P, T)).astype(
        np.int32)


def _oracles(data):
    q = (3, 7, 11, 250)
    return {
        "wordcount": lambda out: out == core.wordcount_oracle(data, VOCAB),
        "histogram": lambda out: np.array_equal(
            out, core.histogram_oracle(data, VOCAB, 13)),
        "inverted": lambda out: out == core.inverted_index_oracle(
            data, q, TASK, 8, 4),
    }


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("segment", [0, 3], ids=["oneshot", "segmented"])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_usecases_equal_oracles(data, P, segment, fused):
    oracle = _oracles(data)
    for name in USECASES:
        cfg = core.JobConfig(_usecase(core, name), task_size=TASK,
                             push_cap=CAP, n_procs=P, segment=segment,
                             fused_map=fused)
        res = core.submit(cfg, data, device="cpu", repeats=_reps(P)).result()
        assert oracle[name](res.output), (name, P, segment, fused)
        assert res.work_per_rank.sum() == (_reps(P) * (
            shard_task_ids(plan_input(N, TASK, P)) >= 0)).sum()


# ---------------------------------------------------------------------------
# parity with JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(USECASES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_p1_result_stats_and_windows_equal_jax(data, name, fused):
    """Both port paths against the reference's unfused engine (its fused
    job does not trace under the installed jax; see ROADMAP)."""
    kw = dict(task_size=TASK, push_cap=CAP, n_procs=1, segment=16)
    reps = _reps(1)
    jh = jcore.submit(jcore.JobConfig(_usecase(jcore, name), **kw), data,
                      repeats=reps)
    th = core.submit(core.JobConfig(_usecase(core, name), fused_map=fused,
                                    **kw), data, device="cpu", repeats=reps)
    jh.step()
    th.step()
    assert_equal(th.windows(), jh.windows())
    _assert_same_result(th.result(), jh.result())


@pytest.fixture(scope="module")
def jax_p8(devices8, data, tmp_path_factory):
    """One 8-device JAX subprocess for the module: each use-case on the
    reference's (unfused) engine, segmented at P = 8 — its per-rank
    windows and carry after the first segment, then its JobResult."""
    d = tmp_path_factory.mktemp("p8")
    np.savez(d / "in.npz", data=data, reps=_reps(8))
    devices8(f"""
        import numpy as np
        import repro.core as core
        from repro.core.windows import EngineCarry
        inp = np.load({str(d / "in.npz")!r})
        usecases = {USECASES!r}
        res = {{}}
        for name in usecases:
            uc = eval(usecases[name], vars(core))
            cfg = core.JobConfig(uc, task_size={TASK}, push_cap={CAP},
                                 n_procs=8, segment=4)
            h = core.submit(cfg, inp["data"], repeats=inp["reps"])
            h.step()
            tag = name
            res[tag + "_windows"] = h.windows()
            for f in EngineCarry._fields:
                res[tag + "_carry_" + f] = np.asarray(getattr(h.carry, f))
            r = h.result()
            for f in {_STATS!r}:
                res[tag + "_" + f] = np.asarray(getattr(r, f))
            res[tag + "_rec"] = np.array(sorted(r.records.items()))
        np.savez({str(d / "out.npz")!r}, **res)
        print("OK")
    """)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("name", list(USECASES))
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_p8_result_stats_and_windows_equal_jax(jax_p8, data, name, fused):
    tag = name
    cfg = core.JobConfig(_usecase(core, name), task_size=TASK, push_cap=CAP,
                         n_procs=8, segment=4, fused_map=fused)
    h = core.submit(cfg, data, device="cpu", repeats=_reps(8))
    h.step()
    assert_equal(h.windows(), jax_p8[tag + "_windows"], "windows")
    for f, leaf in zip(windows.EngineCarry._fields,
                       windows.carry_to_numpy(h.carry)):
        assert_equal(leaf, jax_p8[f"{tag}_carry_{f}"], f"carry.{f}")
    res = h.result()
    assert_equal(np.array(sorted(res.records.items())), jax_p8[tag + "_rec"])
    for f in _STATS:
        assert_equal(np.asarray(getattr(res, f)), jax_p8[f"{tag}_{f}"], f)


def test_jax_carry_loaded_through_carry_from_numpy_finishes_exactly(
        jax_p8, data):
    """The reference's carry after one segment, converted one to one,
    runs the remaining segments on the port to the reference's records."""
    tag = "wordcount"
    leaves = {f: jax_p8[f"{tag}_carry_{f}"]
              for f in windows.EngineCarry._fields}
    carry = windows.carry_from_numpy(leaves, "cpu")
    spec = core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP,
                        n_procs=8, segment=4)
    map_fn = core.as_map_fn(core.WordCount(vocab=VOCAB))
    _, seg_fn, fin_fn = onesided.make_segment_fns(spec, map_fn, "cpu")
    plan = plan_input(N, TASK, 8)
    feed = SegmentFeed(ArraySource(data), plan, shard_task_ids(plan),
                       _reps(8), segment=4, device="cpu", prefetch=False)
    feed.next_segment()                       # the segment JAX already ran
    while (seg := feed.next_segment()) is not None:
        carry = seg_fn(carry, seg)
    keys, vals, overflow = fin_fn(carry)
    keys, vals = keys[0].numpy(), vals[0].numpy()
    live = keys != KEY_SENTINEL
    assert_equal(np.stack([keys[live], vals[live]], 1), jax_p8[tag + "_rec"])
    assert int(overflow[0]) == 0


def test_combine_overflow_equals_jax_and_raises(data):
    kw = dict(task_size=TASK, push_cap=CAP, n_procs=1, combine_capacity=50)
    jres = jcore.submit(jcore.JobConfig(jcore.WordCount(VOCAB), **kw), data)
    tres = core.submit(core.JobConfig(core.WordCount(VOCAB), **kw), data,
                       device="cpu")
    with pytest.raises(jcore.CombineOverflowError) as jerr:
        jres.result()
    with pytest.raises(core.CombineOverflowError) as terr:
        tres.result()
    assert terr.value.result.combine_overflow == \
        jerr.value.result.combine_overflow > 0


# ---------------------------------------------------------------------------
# the feed and the entry points' contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [True, False])
def test_cpu_feed_segments(data, prefetch):
    plan = plan_input(N, TASK, 4)
    ids = shard_task_ids(plan)
    reps = _reps(4)
    feed = SegmentFeed(ArraySource(data), plan, ids, reps, segment=5,
                       device="cpu", prefetch=prefetch)
    start = 0
    while (seg := feed.next_segment()) is not None:
        want = np.full((4, 5), -1, np.int32)
        want[:, :ids.shape[1] - start] = ids[:, start:start + 5]
        assert_equal(seg.task_ids, want)
        assert_equal(seg.tokens, gather_segment(ArraySource(data), plan,
                                                want))
        assert_equal(seg.max_rep, np.where(want >= 0, np.pad(
            reps[:, start:start + 5], ((0, 0), (0, 5 - min(
                5, ids.shape[1] - start))), constant_values=1),
            1).max(axis=0))
        start += 5
    assert feed.exhausted and feed.ready()
    assert feed.stats.segments_built == -(-ids.shape[1] // 5)
    assert feed.stats.prefetch_hits == (feed.stats.segments_built - 1
                                        if prefetch else 0)
    feed.close()
    feed.close()                                  # idempotent


_CFG = dict(usecase=core.WordCount(64), task_size=8, n_procs=1, segment=2)


@pytest.mark.parametrize("option", ["code_rate", "coschedule",
                                    "elastic_load"])
def test_options_outside_the_port_raise_not_implemented(option):
    tokens = np.zeros((64,), np.int32)
    cfg = dict(_CFG)
    if option == "code_rate":
        # ported: r 2 needs ranks in groups of 2, and runs to the oracle
        cfg.update(code_rate=2, n_procs=2)
        res = core.submit(core.JobConfig(**cfg), tokens,
                          device="cpu").result()
        assert res.records == core.wordcount_oracle(tokens, 64)
        return
    if option == "coschedule":
        # ported: the scheduler takes the options and forms no domain for
        # a lone job
        sched = core.JobScheduler(device="cpu", coschedule=True, copack=2)
        sched.submit(core.JobConfig(**cfg), tokens, name="a")
        assert sched.run_until_complete()["a"].records == \
            core.wordcount_oracle(tokens, 64)
        assert sched._domains == []
        return
    if option == "elastic_load":
        # ported: empty windows and the whole grid re-bucketized onto the
        # handle's ranks run to the oracle
        from repro_torch.ft.elastic import rebucketize_tasks
        h = core.submit(core.JobConfig(**cfg), tokens, device="cpu")
        ids, reps = rebucketize_tasks(h.feed.task_ids_grid,
                                      h.feed.repeats_grid, 0, 1)
        h.elastic_load(np.zeros((1, 64), np.int32),
                       np.zeros((64,), np.int32), np.ones((64,), np.int32),
                       ids, reps)
        assert h.result().records == core.wordcount_oracle(tokens, 64)
        return


@pytest.mark.parametrize("option", ["stealing", "sampled", "sampled+split",
                                    "feed_budget"])
@pytest.mark.parametrize("P", [1, 4])
def test_options_ported_since_run(option, P):
    """Work stealing, the sampled partitioners and a shared feed budget,
    which raised before they were ported, run through ``submit`` to the
    oracle's records (a one-byte budget grants a lone feed every
    prefetch, since nothing else is held, and gets each back)."""
    from repro_torch.data import FeedBudget
    tokens = np.random.default_rng(P).integers(0, 64, 640).astype(np.int32)
    cfg = dict(_CFG, n_procs=P)
    kw = {}
    if option == "stealing":
        cfg["stealing"] = True
    elif option == "feed_budget":
        kw["feed_budget"] = budget = FeedBudget(1)
    else:
        cfg["partitioner"] = option
    h = core.submit(core.JobConfig(**cfg), tokens, device="cpu", **kw)
    res = h.result()
    assert res.records == core.wordcount_oracle(tokens, 64)
    assert res.partitioner == (option if option.startswith("sampled")
                               else "hash")
    assert h.feed.stats.sample_tasks_read == (
        16 if option.startswith("sampled") else 0)
    if option == "feed_budget":
        assert budget.live_bytes == 0
        assert budget.denials == h.feed.stats.budget_denials == 0
        assert h.feed.stats.prefetch_hits > 0


def test_submit_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        core.submit(core.JobConfig(**_CFG), np.zeros((64,), np.int32))


def test_registry_and_step_contract(data):
    assert core.available_backends() == ["1s", "2s"]
    assert core.get_backend("1s") is core.get_backend("1s")
    with pytest.raises(core.UnknownBackendError):
        core.get_backend("nope")
    h = core.submit(core.JobConfig(core.WordCount(VOCAB), task_size=TASK,
                                   push_cap=CAP, n_procs=2), data,
                    device="cpu")
    with pytest.raises(RuntimeError, match="segmented"):
        h.step()
    res = h.result()
    assert h.done and h.result() is res and not h.step()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_blocking_run_job_equals_reference_run_job(data, fused):
    """The blocking ``run_job`` over a resident pre-shard gives the
    reference's rank-0 records."""
    from repro.core.onesided import run_job as jrun_job
    from repro.core.registry import JobSpec as JSpec
    from repro.core.usecase import as_map_fn as jas_map_fn
    from repro.distributed.mesh import local_mesh
    plan = plan_input(N, TASK, 1)
    ids = shard_task_ids(plan)
    tokens = gather_segment(ArraySource(data), plan, ids)
    reps = _reps(1)
    keys, vals = onesided.run_job(
        core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP, n_procs=1,
                     fused_map=fused),
        core.as_map_fn(core.WordCount(VOCAB)), "cpu", tokens, ids, reps)
    jkeys, jvals = jrun_job(
        JSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP, n_procs=1),
        jas_map_fn(jcore.WordCount(VOCAB)), local_mesh((1,), ("procs",)),
        tokens, ids, reps)
    assert_equal(keys, jkeys)
    assert_equal(vals, jvals)


def test_feed_prime_ready_and_read_tasks(data):
    plan = plan_input(N, TASK, 2)
    ids = shard_task_ids(plan)
    feed = SegmentFeed(ArraySource(data), plan, ids, _reps(2), segment=4,
                       device="cpu")
    try:
        feed.prime()
        feed.prime()                                  # idempotent
        feed._pending[1].result(timeout=60)
        assert feed.ready()
        assert feed.next_segment() is not None
        assert feed.stats.prefetch_hits == 1
        feed.close()                    # waits for the prefetch in flight
        before = feed.stats.bytes_read
        got = feed.read_tasks(np.array([[5, -1], [0, 127]]))
        assert_equal(got, gather_segment(ArraySource(data), plan,
                                         np.array([[5, -1], [0, 127]])))
        assert feed.stats.bytes_read - before == 4 * TASK * 4
    finally:
        feed.close()
