"""The port's coded shuffle against the JAX package's.

``repro_torch.core.coded`` (group math, ``replicate_grids``, the bytes
model) equals ``repro.core.coded`` over a grid of (P, r);
``collectives.coded_exchange`` on seeded (P, P, cap) buckets equals the
reference's under ``shard_map`` on 6 host devices, r 2 and 3; whole coded
jobs equal the reference's ``JobResult`` bit for bit (records,
``work_per_rank``, ``tasks_per_rank``) at P 6, r in {1, 2, 3}, under
``hash`` and ``sampled+split``, and for the three use-cases at P 2, r 2.
The reference's coded stealing job does not trace under the installed
jax (its claim loop's carry types), so the port's coded stealing is held
to the group host replay (``steal.coded_steal_schedule``, itself equal to
the reference's ``steal_schedule`` run over the groups' block grids) and
to the oracle. An r 2, P 2 snapshot restores across the packages both
ways; the guards refuse an r mismatch, ``replan`` refuses a coded
handle, ``JobSpec`` and ``"2s"`` refuse what the reference refuses. One
6-device JAX subprocess serves the module. Tolerance 0 (integers).
"""
import collections
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.coded as jcoded  # noqa: E402
import repro.core.steal as jsteal  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.core.registry import JobSpec as JSpec  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import coded, steal  # noqa: E402
from repro_torch.core.planner import plan_input  # noqa: E402
from repro_torch.core.registry import JobSpec  # noqa: E402
from repro_torch.data.corpus import synth_corpus, zipf_skew_repeats  # noqa: E402
from repro_torch.distributed.collectives import coded_exchange  # noqa: E402
from torch_parity import (REPO, USECASES, assert_equal,  # noqa: E402
                          result_summary, usecase)

# the whole-job matrix (the reference's exactness matrix shapes)
VOCAB, N, TASK, CAP, P = 600, 24576, 512, 512, 6
T = plan_input(N, TASK, P).tasks_per_proc
PARTS = ("hash", "sampled+split")
# the use-cases at P 2, r 2, and the checkpoint round trip
UC_N, UC_TASK, UC_CAP, UC_SEG = 8192, 64, 16, 4
CK_VOCAB, CK_N, CK_TASK, CK_P = 300, 8192, 256, 2
XCAP = 24                      # coded_exchange's buckets


def _reps():
    return zipf_skew_repeats(P, T, 1.4, mean_rep=3, seed=1)


def _uc_tokens():
    rng = np.random.default_rng(5)
    return (rng.zipf(1.4, UC_N) % 300).astype(np.int32)


def _buckets(r, seed):
    """Seeded (P, P, cap) int32 buckets, equal on the members of each
    r-group (as the coded step makes them), sentinels among them."""
    rng = np.random.default_rng(seed)
    bk = rng.integers(-2**31, 2**31 - 1, (P // r, P, XCAP), dtype=np.int64)
    bk = np.where(rng.random(bk.shape) < 0.3, 2**31 - 1, bk)
    bv = rng.integers(-50, 50, (P // r, P, XCAP))
    rep = np.repeat(np.arange(P // r), r)
    return bk[rep].astype(np.int32), bv[rep].astype(np.int32)


def _job_cfg(pkg, r, part="hash", stealing=False, segment=0):
    return pkg.JobConfig(pkg.WordCount(vocab=VOCAB), backend="1s",
                         task_size=TASK, push_cap=CAP, n_procs=P,
                         partitioner=part, stealing=stealing, code_rate=r,
                         segment=segment)


def _ck_cfg(pkg, r):
    return pkg.JobConfig(pkg.WordCount(vocab=CK_VOCAB), backend="1s",
                         task_size=CK_TASK, push_cap=256, n_procs=CK_P,
                         segment=2, code_rate=r)


@pytest.fixture(scope="module")
def tokens():
    return synth_corpus(N, VOCAB, seed=0)


@pytest.fixture(scope="module")
def ck_tokens():
    return synth_corpus(CK_N, CK_VOCAB, seed=3)


@pytest.fixture(scope="module")
def port_snapshot(tmp_path_factory, ck_tokens):
    """The port's r 2, P 2 job checkpointed after one segment."""
    d = tmp_path_factory.mktemp("port_snap")
    h = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu")
    h.step()
    mgr = CheckpointManager(str(d))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    return d


@pytest.fixture(scope="module")
def reference(devices8, tmp_path_factory, tokens, ck_tokens, port_snapshot):
    """Everything the module holds the port to, from one 6-device JAX
    subprocess: ``coded_exchange`` outputs, the job matrix's and the
    use-cases' results, the port's snapshot restored and finished by the
    reference, and the reference's own snapshot."""
    d = tmp_path_factory.mktemp("coded_ref")
    np.save(d / "tokens.npy", tokens)
    np.save(d / "ck.npy", ck_tokens)
    np.save(d / "uc.npy", _uc_tokens())
    np.save(d / "reps.npy", _reps())
    for r in (2, 3):
        bk, bv = _buckets(r, r)
        np.save(d / f"bk{r}.npy", bk)
        np.save(d / f"bv{r}.npy", bv)
    devices8(f"""
        import json, sys
        import numpy as np
        import jax
        sys.path.insert(0, {REPO!r} + "/tests")
        import repro.core as core
        from jax.sharding import PartitionSpec as PS
        from repro.ckpt.checkpoint import CheckpointManager
        from repro.distributed.collectives import coded_exchange, shard_map
        from repro.distributed.mesh import local_mesh
        from torch_parity import USECASES, result_summary, usecase
        d = {str(d)!r}
        out = {{"exchange": {{}}, "jobs": {{}}, "usecases": {{}}}}
        mesh = local_mesh(({P},), ("procs",))
        for r in (2, 3):
            def body(k, v, r=r):
                rk, rv = coded_exchange(k[0], v[0], "procs", r)
                return rk[None], rv[None]
            f = jax.jit(shard_map(body, mesh=mesh,
                                  in_specs=(PS("procs"), PS("procs")),
                                  out_specs=(PS("procs"), PS("procs"))))
            rk, rv = f(np.load(d + f"/bk{{r}}.npy"),
                       np.load(d + f"/bv{{r}}.npy"))
            np.save(d + f"/rk{{r}}.npy", np.asarray(rk))
            np.save(d + f"/rv{{r}}.npy", np.asarray(rv))
        tokens = np.load(d + "/tokens.npy")
        reps = np.load(d + "/reps.npy")
        for r in (1, 2, 3):
            for part in {PARTS!r}:
                cfg = core.JobConfig(core.WordCount(vocab={VOCAB}),
                                     backend="1s", task_size={TASK},
                                     push_cap={CAP}, n_procs={P},
                                     partitioner=part, code_rate=r)
                res = core.submit(cfg, tokens, repeats=reps).result()
                out["jobs"][f"{{r}} {{part}}"] = result_summary(res)
        uc = np.load(d + "/uc.npy")
        T2 = -(-(-(-len(uc) // {UC_TASK})) // 2)
        ucreps = (1 + np.arange(2 * T2) % 3).reshape(2, T2)
        mesh2 = local_mesh((2,), ("procs",))
        for name in USECASES:
            cfg = core.JobConfig(usecase(core, name), backend="1s",
                                 task_size={UC_TASK}, push_cap={UC_CAP},
                                 n_procs=2, segment={UC_SEG}, code_rate=2)
            res = core.submit(cfg, uc, mesh=mesh2, repeats=ucreps).result()
            out["usecases"][name] = result_summary(res)
        ck = np.load(d + "/ck.npy")

        def ck_cfg(r):
            return core.JobConfig(core.WordCount(vocab={CK_VOCAB}),
                                  backend="1s", task_size={CK_TASK},
                                  push_cap=256, n_procs={CK_P}, segment=2,
                                  code_rate=r)
        port = CheckpointManager({str(port_snapshot)!r})
        h = core.submit(ck_cfg(2), ck, mesh=mesh2).restore(port)
        out["port_snapshot_records"] = sorted(h.result().records.items())
        try:
            core.submit(ck_cfg(1), ck, mesh=mesh2).restore(port)
            out["port_snapshot_into_r1"] = "restored"
        except ValueError as e:
            out["port_snapshot_into_r1"] = str(e)
        h = core.submit(ck_cfg(2), ck, mesh=mesh2)
        h.step()
        mgr = CheckpointManager(d + "/ref_snap")
        h.checkpoint(mgr)
        mgr.wait()
        h.close()
        with open(d + "/out.json", "w") as f:
            json.dump(out, f)
        print("OK")
    """, n_devices=P)
    out = json.loads((d / "out.json").read_text())
    out["dir"] = d
    return out


# ---------------------------------------------------------------------------
# the host half against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_group_math_equals_the_reference(r):
    for q in range(12):
        assert coded.group_of(q, r) == jcoded.group_of(q, r)
        assert coded.member_of(q, r) == jcoded.member_of(q, r)


@pytest.mark.parametrize("P_,r", [(2, 1), (2, 2), (4, 2), (6, 2), (6, 3),
                                  (8, 2), (8, 4), (6, 6)])
def test_replicate_grids_equals_the_reference(P_, r):
    """Random ids with padding inside rows and random repeats: equal
    output, every member of a group on one row, each real id r times."""
    rng = np.random.default_rng(P_ * 10 + r)
    T_ = 7
    ids = rng.permutation(P_ * T_).astype(np.int32).reshape(P_, T_)
    ids[rng.random(ids.shape) < 0.2] = -1
    reps = rng.integers(1, 9, (P_, T_)).astype(np.int32)
    got = coded.replicate_grids(ids, reps, r)
    want = jcoded.replicate_grids(ids, reps, r)
    for a, b in zip(got, want):
        assert_equal(a, b)
        assert a.dtype == np.int32 and a.shape == (P_, T_ * r)
    for g in range(P_ // r):
        assert (got[0][g * r: (g + 1) * r] == got[0][g * r]).all()
    for t in ids[ids >= 0].tolist():
        assert (got[0] == t).sum() == r


def test_replicate_grids_r1_identity_padding_and_refusal():
    ids = np.arange(12, dtype=np.int32).reshape(4, 3)
    reps = np.full((4, 3), 2, np.int32)
    for a, b in zip(coded.replicate_grids(ids, reps, 1), (ids, reps)):
        assert_equal(a, b)
    pad = np.array([[0, 1], [2, -1]], np.int32)
    out, _ = coded.replicate_grids(pad, np.ones_like(pad), 2)
    assert_equal(out, [[0, 2, 1, -1], [0, 2, 1, -1]])
    with pytest.raises(ValueError, match="divisible"):
        coded.replicate_grids(np.zeros((5, 2), np.int32),
                              np.ones((5, 2), np.int32), 2)


@pytest.mark.parametrize("P_", [1, 2, 4, 6, 8, 12])
def test_shuffle_bytes_equal_the_reference(P_):
    assert coded.RECORD_BYTES == jcoded.RECORD_BYTES
    for r in [x for x in range(1, P_ + 1) if P_ % x == 0]:
        assert coded.shuffle_blocks_per_step(P_, r) == \
            jcoded.shuffle_blocks_per_step(P_, r)
        for steps, cap in ((1, 1), (32, 1024), (7, 512)):
            assert coded.shuffle_bytes(P_, steps, cap, r) == \
                jcoded.shuffle_bytes(P_, steps, cap, r)
    # fig15's ratios at P 6
    r1 = coded.shuffle_bytes(6, 32, 1024, 1)
    assert coded.shuffle_bytes(6, 32, 1024, 2) / r1 == pytest.approx(0.6)
    assert coded.shuffle_bytes(6, 32, 1024, 3) / r1 == pytest.approx(0.4)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(code_rate=0), "code_rate"),
    (dict(n_procs=6, code_rate=4), "divisible"),
    (dict(code_rate=2, fused_map=True), "fused_map"),
    (dict(code_rate=2, coslots=2, costride=16), "coslots"),
    (dict(coslots=2, costride=16, fused_map=True), "fused_map.*coslots"),
    (dict(coslots=2, costride=0), "costride"),
    (dict(vocab=63, coslots=2, costride=16), "equal per-job windows")])
def test_jobspec_refuses_as_the_reference_does(kw, match):
    base = dict(vocab=64, task_size=8, push_cap=8, n_procs=4)
    base.update(kw)
    with pytest.raises(ValueError, match=match) as mine:
        JobSpec(**base)
    with pytest.raises(ValueError) as ref:
        JSpec(**base)
    assert str(mine.value) == str(ref.value)


def test_jobspec_takes_what_the_reference_takes():
    spec = JobSpec(vocab=64, task_size=8, push_cap=8, n_procs=6, code_rate=3)
    assert spec.code_rate == 3 and spec.coslots == 1
    assert JobSpec(vocab=64, task_size=8, push_cap=8, n_procs=4, coslots=2,
                   costride=16).coslots == 2


def test_code_rate_is_part_of_the_program():
    a = JobSpec(vocab=64, task_size=8, push_cap=8, n_procs=4)
    b = JobSpec(vocab=64, task_size=8, push_cap=8, n_procs=4, code_rate=2)
    assert a != b and len({a, b}) == 2
    assert a == JobSpec(vocab=64, task_size=8, push_cap=8, n_procs=4,
                        partitioner="sampled")


def test_twosided_refuses_code_rate(ck_tokens):
    cfg = core.JobConfig(core.WordCount(vocab=32), backend="2s",
                         task_size=16, push_cap=16, n_procs=2, code_rate=2)
    with pytest.raises(ValueError, match="supports_coded"):
        core.submit(cfg, ck_tokens, device="cpu")


# ---------------------------------------------------------------------------
# the exchange and whole jobs against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [2, 3])
def test_coded_exchange_equals_the_reference(reference, r):
    d = reference["dir"]
    bk, bv = _buckets(r, r)
    rk, rv = coded_exchange(torch.from_numpy(bk), torch.from_numpy(bv), r)
    assert_equal(rk, np.load(d / f"rk{r}.npy"), "keys")
    assert_equal(rv, np.load(d / f"rv{r}.npy"), "values")


@pytest.mark.parametrize("r", [2, 3])
def test_coded_exchange_delivers_each_bucket_once(r):
    """Every rank's bucket for destination q reaches q exactly once: the
    decoded row (its designated peer's) for a destination in its group,
    the speaker's row for one outside it; every other row is empty."""
    bk, bv = _buckets(r, 10 + r)
    rk, rv = (x.numpy() for x in coded_exchange(
        torch.from_numpy(bk), torch.from_numpy(bv), r))
    SENT = 2**31 - 1
    for q in range(P):
        g, m = q // r, q % r
        for src in range(P):
            if src // r == g:
                want_on = src == g * r + (m + 1) % r
            else:
                want_on = src % r == m
            if want_on:
                assert_equal(rk[q, src], bk[src, q])
                assert_equal(rv[q, src], bv[src, q])
            else:
                assert (rk[q, src] == SENT).all() and (rv[q, src] == 0).all()


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("r", [1, 2, 3])
def test_coded_jobs_equal_the_reference(reference, tokens, r, part):
    res = core.submit(_job_cfg(core, r, part), tokens, repeats=_reps(),
                      device="cpu").result()
    got = json.loads(json.dumps(result_summary(res)))
    assert got == reference["jobs"][f"{r} {part}"]
    oracle = dict(collections.Counter(tokens.tolist()))
    assert res.records == oracle
    assert res.tasks_per_rank.tolist() == [8 * r] * P
    assert res.work_per_rank.tolist() == {
        1: [77, 34, 22, 10, 11, 10], 2: [111, 111, 32, 32, 21, 21],
        3: [133, 133, 133, 31, 31, 31]}[r]


@pytest.mark.parametrize("name", list(USECASES))
def test_coded_usecases_equal_the_reference(reference, name):
    uc = _uc_tokens()
    T2 = -(-(-(-len(uc) // UC_TASK)) // 2)
    cfg = core.JobConfig(usecase(core, name), backend="1s",
                         task_size=UC_TASK, push_cap=UC_CAP, n_procs=2,
                         segment=UC_SEG, code_rate=2)
    res = core.submit(cfg, uc, device="cpu",
                      repeats=(1 + np.arange(2 * T2) % 3).reshape(2, T2)
                      ).result()
    got = json.loads(json.dumps(result_summary(res)))
    assert got == reference["usecases"][name]


@pytest.mark.parametrize("segment", [0, 1, 3])
def test_segmented_coded_job_equals_oneshot(tokens, segment):
    """The feed hands out segments of ``segment * r`` columns, the last
    one padded: the records and stats equal the oneshot job's."""
    want = core.submit(_job_cfg(core, 2), tokens, repeats=_reps(),
                       device="cpu").result()
    h = core.submit(_job_cfg(core, 2, segment=segment), tokens,
                    repeats=_reps(), device="cpu")
    assert h.feed.segment == 2 * (segment or T)
    got = h.result()
    assert result_summary(got) == result_summary(want)


# ---------------------------------------------------------------------------
# coded stealing: the group replay and the oracle
# ---------------------------------------------------------------------------

def _block_grid(ids, reps, r):
    """The groups' (G, nb) block grids as the reference's replay reads
    them: a live block's id is its index, its repeat its live cost."""
    P_, n = ids.shape
    gids = ids[::r].reshape(P_ // r, n // r, r)
    greps = reps[::r].reshape(P_ // r, n // r, r)
    live = (gids >= 0).any(axis=2)
    bid = np.where(live, np.arange(n // r), -1).astype(np.int32)
    cost = np.where(gids >= 0, greps, 0).sum(axis=2).astype(np.int32)
    return bid, np.where(live, cost, 1).astype(np.int32)


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_coded_steal_schedule_equals_the_reference_over_groups(r, seed):
    """The group claim equals the reference's ``steal_schedule`` run over
    the groups' block grids, ``work0`` carried; every live block runs
    once; members agree."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(P * 6).astype(np.int32).reshape(P, 6)
    ids[rng.random(ids.shape) < 0.25] = -1
    reps = rng.integers(1, 9, (P, 6)).astype(np.int32)
    rids, rreps = coded.replicate_grids(ids, reps, r)
    work0 = np.repeat(rng.integers(0, 20, P // r), r).astype(np.int32)
    got = steal.coded_steal_schedule(rids, rreps, r, work0=work0)
    bid, cost = _block_grid(rids, rreps, r)
    want = jsteal.steal_schedule(bid, cost, work0=work0[::r])
    assert_equal(got.src_group, want.src_rank)
    assert_equal(got.src_col, want.src_col)
    assert_equal(got.src_block, want.exec_ids)
    assert_equal(got.work[::r], want.work)
    assert_equal(got.stolen[::r], want.stolen)
    for a in (got.work, got.stolen):
        assert (a.reshape(-1, r) == a[::r, None]).all()
    ran = got.exec_ids[::r][got.exec_ids[::r] >= 0]
    assert sorted(ran.tolist()) == sorted(ids[ids >= 0].tolist())


def _grid():
    from repro_torch.core.planner import shard_task_ids
    return shard_task_ids(plan_input(N, TASK, P))


def _coded_replay(ids, reps, r, seg_cols):
    """The group replay segment by segment as the feed pads them."""
    work, passes, steals = None, 0, 0
    for lo in range(0, ids.shape[1], seg_cols):
        g = np.full((ids.shape[0], seg_cols), -1, np.int32)
        rp = np.ones_like(g)
        w = min(seg_cols, ids.shape[1] - lo)
        g[:, :w], rp[:, :w] = ids[:, lo:lo + w], reps[:, lo:lo + w]
        s = steal.coded_steal_schedule(g, rp, r, work0=work)
        work, passes, steals = s.work, passes + s.passes, steals + s.n_stolen
    return work, passes, steals


@pytest.mark.parametrize("segment", [0, 2])
@pytest.mark.parametrize("r", [2, 3])
def test_coded_stealing_equals_the_replay_and_the_oracle(tokens, r,
                                                         segment):
    h = core.submit(_job_cfg(core, r, stealing=True, segment=segment),
                    tokens, repeats=_reps(), device="cpu")
    res = h.result()
    assert res.records == dict(collections.Counter(tokens.tolist()))
    rids, rreps = coded.replicate_grids(_grid(), _reps(), r)
    work, passes, steals = _coded_replay(rids, rreps, r, h.feed.segment)
    assert_equal(res.work_per_rank, work)
    assert res.n_steals == steals > 0
    assert h.engine.steal.passes == passes
    w = res.work_per_rank.reshape(-1, r)
    assert (w == w[:, :1]).all()
    assert int(res.work_per_rank[::r].sum()) == int(_reps().sum())


def test_coded_stealing_balances_the_skewed_groups(tokens):
    """At r 2 the unstolen job's group work is 111/32/21; stealing
    brings max over mean down (the replay's row, held above)."""
    plain = core.submit(_job_cfg(core, 2), tokens, repeats=_reps(),
                        device="cpu").result()
    stolen = core.submit(_job_cfg(core, 2, stealing=True), tokens,
                         repeats=_reps(), device="cpu").result()
    assert stolen.imbalance < plain.imbalance


# ---------------------------------------------------------------------------
# checkpoints across the packages, and the guards
# ---------------------------------------------------------------------------

def test_coded_checkpoint_round_trip_in_the_port(tmp_path, ck_tokens):
    oracle = dict(collections.Counter(ck_tokens.tolist()))
    mgr = CheckpointManager(str(tmp_path))
    h = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu")
    h.step()
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    _, extra = mgr.peek()
    assert extra["code_rate"] == 2 and extra["cursor"] == 4
    h2 = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu").restore(mgr)
    assert h2.cursor == 4
    assert h2.result().records == oracle


def test_port_snapshot_restores_into_the_reference(reference, ck_tokens):
    oracle = dict(collections.Counter(ck_tokens.tolist()))
    assert dict(map(tuple, reference["port_snapshot_records"])) == oracle
    assert "code_rate" in reference["port_snapshot_into_r1"]


def test_reference_snapshot_restores_into_the_port(reference, ck_tokens,
                                                   port_snapshot):
    mgr = CheckpointManager(str(reference["dir"] / "ref_snap"))
    _, extra = mgr.peek()
    _, mine = CheckpointManager(str(port_snapshot)).peek()
    for key in ("cursor", "code_rate", "coslots", "task_ids", "repeats"):
        assert extra[key] == mine[key], key
    h = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu").restore(mgr)
    assert h.result().records == dict(collections.Counter(
        ck_tokens.tolist()))


def test_coded_guards_refuse_r1_and_replan(reference, ck_tokens,
                                           port_snapshot):
    for snap in (reference["dir"] / "ref_snap", port_snapshot):
        with pytest.raises(ValueError, match="code_rate"):
            core.submit(_ck_cfg(core, 1), ck_tokens,
                        device="cpu").restore(CheckpointManager(str(snap)))
    h = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu")
    with pytest.raises(ValueError, match="code_rate"):
        h.replan(np.zeros((CK_P, 1), np.int32))
    h.close()


def test_straggler_replan_refuses_a_coded_handle(ck_tokens):
    from repro_torch.ft import straggler
    h = core.submit(_ck_cfg(core, 2), ck_tokens, device="cpu")
    h.step()
    tracker = straggler.ThroughputTracker(CK_P)
    tracker.update(np.asarray([1.0, 4.0]))
    with pytest.raises(ValueError, match="code_rate"):
        straggler.replan_handle(h, tracker)
    h.close()
