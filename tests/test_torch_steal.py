"""The port's work stealing against the JAX package's claim function.

``claim_step`` equals the reference's jitted claim on random cursor
states (P in {2, 4, 8}); ``steal_schedule`` equals the reference's host
replay in every field, ``work0`` carried, on the unbalanced, Zipf,
random and padded grids, and claims every task exactly once. The
reference's stealing job does not trace under the installed jax (its
claim loop's carry types), so the port's stealing jobs are held to the
use-case oracles and to the replay: P = 1 and 8, oneshot and segmented,
eager, fused (its plain version on the CPU) and through ``StepGraphs``
(its capture replaced by an eager replay): records equal the oracle and
the carry's ``work`` and ``stolen`` rows the replay's, carried across
segments. A stealing checkpoint restores and finishes exactly, the
guards refuse a ``stealing`` mismatch, ``"2s"`` refuses stealing, and
``outer_rebalance`` on a live stealing handle decides as the
reference's. Tolerance 0 (integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.steal as jsteal  # noqa: E402
import repro.ft.straggler as jstraggler  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.steal as steal  # noqa: E402
import repro_torch.ft.straggler as straggler  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import onesided  # noqa: E402
from repro_torch.core.planner import plan_input, shard_task_ids  # noqa: E402
from repro_torch.data.corpus import (imbalance_repeats,  # noqa: E402
                                     zipf_skew_repeats)
from repro_torch.kernels.fused_map.ops import fused_map  # noqa: E402
from torch_parity import USECASES, assert_equal, usecase  # noqa: E402

VOCAB, N, TASK, CAP, SEG = 300, 8192, 64, 8, 4
FIELDS = ("src_rank", "src_col", "exec_ids", "exec_reps", "work", "stolen",
          "slot_work")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.zipf(1.4, N) % VOCAB).astype(np.int32)


def random_grid(rng, P):
    """Random assignment grid: random width, unique global ids, random
    right-padding per rank, random repeats (the reference test's)."""
    T = int(rng.integers(1, 9))
    counts = rng.integers(0, T + 1, size=P)
    if counts.sum() == 0:
        counts[int(rng.integers(0, P))] = 1
    ids = -np.ones((P, T), np.int32)
    pool = rng.permutation(int(counts.sum()))
    k = 0
    for r in range(P):
        ids[r, : counts[r]] = pool[k: k + counts[r]]
        k += counts[r]
    reps = rng.integers(1, 9, size=(P, T)).astype(np.int32)
    return ids, reps


# ---------------------------------------------------------------------------
# the claim and the replay against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", [1, 3])
@pytest.mark.parametrize("P", [2, 4, 8])
def test_claim_step_equals_jax(P, margin):
    """250 random (head, tail, work) states, empty deques, tied work rows
    and rows below 0 among them: every output equal to the reference's
    jitted claim."""
    rng = np.random.default_rng(P * 10 + margin)
    jclaim = jsteal._jitted_claim(margin)
    for trial in range(250):
        head = rng.integers(0, 6, P).astype(np.int32)
        tail = (head + rng.integers(0, 4, P) * (rng.random(P) < 0.7)) \
            .astype(np.int32)
        work = rng.integers(0, 3 if trial % 2 else 30, P).astype(np.int32)
        if trial % 5 == 0:
            work -= 2                   # the argmax's -1 ties empty ranks
        got = steal.claim_step(head, tail, work, margin)
        want = jclaim(head, tail, work)
        for f, a, b in zip(("src_rank", "src_col", "head", "tail"), got,
                           want):
            assert a.dtype == np.int32
            assert_equal(a, b, f"trial {trial}: {f}")


@pytest.mark.parametrize("P", [2, 4, 8])
def test_every_task_claimed_exactly_once(P):
    rng = np.random.default_rng(P)
    for _ in range(40):
        ids, reps = random_grid(rng, P)
        work0 = rng.integers(0, 40, size=P).astype(np.int32)
        sched = steal.steal_schedule(ids, reps, work0=work0)
        executed = sched.exec_ids[sched.exec_ids >= 0]
        assert sorted(executed.tolist()) == sorted(ids[ids >= 0].tolist())
        assert int(sched.exec_reps.sum()) == int(reps[ids >= 0].sum())
        assert_equal(sched.work - work0, sched.exec_reps.sum(axis=1))


def _grids(kind, P=8, T=48, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(P * T, dtype=np.int32).reshape(P, T)
    if kind == "unbalanced":
        reps = imbalance_repeats(P, T, mode="unbalanced", hot_factor=8,
                                 hot_fraction=0.125)
    elif kind == "zipf":
        reps = zipf_skew_repeats(P, T, 1.1, mean_rep=4, seed=1)
    elif kind == "balanced":
        reps = np.ones((P, T), np.int32)
    elif kind == "random":
        ids = rng.permutation(P * T).astype(np.int32).reshape(P, T)
        reps = rng.integers(1, 9, (P, T)).astype(np.int32)
    else:                           # padded: ragged rows, holes inside
        reps = rng.integers(1, 6, (P, T)).astype(np.int32)
        for r in range(P):
            ids[r, T - 3 * r:] = -1
        ids[rng.random((P, T)) < 0.1] = -1
    return ids, reps


@pytest.mark.parametrize("width", [16, 48])
@pytest.mark.parametrize("kind", ["unbalanced", "zipf", "balanced", "random",
                                  "padded"])
def test_steal_schedule_equals_jax(kind, width):
    """Segments of ``width`` columns in turn, ``work0`` carried from each
    replay to the next, every field equal to the reference's."""
    ids, reps = _grids(kind)
    work_t = work_j = np.zeros(8, np.int32)
    for lo in range(0, ids.shape[1], width):
        g, r = ids[:, lo:lo + width], reps[:, lo:lo + width]
        got = steal.steal_schedule(g, r, work0=work_t)
        want = jsteal.steal_schedule(g, r, work0=work_j)
        for f in FIELDS:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype, f
            assert_equal(a, b, f"columns {lo}: {f}")
        assert got.n_stolen == want.n_stolen
        work_t, work_j = got.work, want.work
    if kind == "balanced":
        assert got.n_stolen == 0
    if kind in ("unbalanced", "zipf"):
        assert got.n_stolen > 0


def test_cursors_and_compaction_equal_jax():
    ids, _ = _grids("padded")
    for a, b in zip(steal.segment_cursors(ids),
                    jsteal.segment_cursors(ids)):
        assert_equal(a, b)
    got = steal.compact_columns(ids)
    for r in range(ids.shape[0]):
        assert_equal(got[r], jsteal.compact_columns(ids[r]))
    assert steal.STEAL_MARGIN == jsteal.STEAL_MARGIN


def test_passes_count_each_steps_max_repeat():
    ids, reps = _grids("unbalanced")
    sched = steal.steal_schedule(ids, reps)
    assert sched.passes == int(np.maximum(sched.exec_reps, 1).max(
        axis=0).sum())
    assert sched.passes < int(reps.max(axis=0).sum())   # stealing pays


# ---------------------------------------------------------------------------
# stealing jobs on the CPU
# ---------------------------------------------------------------------------

GRIDS = ("unbalanced", "zipf", "random")
MODES = {"oneshot": 0, "segmented": SEG}


def _reps(kind, P):
    T = plan_input(N, TASK, P).tasks_per_proc
    if kind == "zipf":
        return zipf_skew_repeats(P, T, 1.1, mean_rep=4, seed=1)
    if kind == "random":
        return np.random.default_rng(P).integers(1, 6, (P, T)).astype(
            np.int32)
    return imbalance_repeats(P, T, mode=kind, hot_factor=8,
                             hot_fraction=0.125)


def _cfg(P, mode, fused=False, name="wordcount", **kw):
    return core.JobConfig(usecase(core, name), task_size=TASK, push_cap=CAP,
                          n_procs=P, segment=MODES[mode], fused_map=fused,
                          stealing=True, **kw)


def _padded(ids, reps, lo, width):
    """Columns ``[lo, lo + width)`` of the grids, padded as the feed pads
    a segment."""
    P, T = ids.shape
    g = np.full((P, width), -1, np.int32)
    r = np.ones((P, width), np.int32)
    g[:, :min(width, T - lo)] = ids[:, lo:lo + width]
    r[:, :min(width, T - lo)] = reps[:, lo:lo + width]
    return g, r


def _replay(P, reps, width, mod=steal):
    """The job's schedule replayed segment by segment on the host, with
    the feed's padding: the final work row and the summed stolen row."""
    plan = plan_input(N, TASK, P)
    ids = shard_task_ids(plan)
    T = ids.shape[1]
    work, stolen, passes = np.zeros(P, np.int32), np.zeros(P, np.int32), 0
    for lo in range(0, T, width):
        s = mod.steal_schedule(*_padded(ids, reps, lo, width), work0=work)
        work, stolen = np.asarray(s.work), stolen + np.asarray(s.stolen)
        passes += int(np.maximum(np.asarray(s.exec_reps), 1).max(
            axis=0).sum())
    return work, stolen, passes


def _oracle(data, name):
    uc = usecase(core, name)
    if name == "wordcount":
        return core.wordcount_oracle(data, VOCAB)
    if name == "histogram":
        return {k: int(v) for k, v in enumerate(
            core.histogram_oracle(data, VOCAB, 13)) if v}
    return core.submit(core.JobConfig(uc, task_size=TASK, push_cap=CAP,
                                      n_procs=1), data,
                       device="cpu").result().records


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("P", [1, 8])
def test_stealing_job_equals_oracle_and_replay(data, P, grid, mode, fused):
    reps = _reps(grid, P)
    h = core.submit(_cfg(P, mode, fused), data, device="cpu", repeats=reps)
    res = h.result()
    assert res.records == core.wordcount_oracle(data, VOCAB)
    width = MODES[mode] or reps.shape[1]
    work, stolen, passes = _replay(P, reps, width)
    assert_equal(res.work_per_rank, work, "work")
    assert_equal(res.steals_per_rank, stolen, "stolen")
    jwork, jstolen, _ = _replay(P, reps, width, jsteal)
    assert_equal(work, jwork)
    assert_equal(stolen, jstolen)
    st = h.engine.steal
    assert st.passes == passes
    assert st.segments == -(-reps.shape[1] // width)
    assert int(res.work_per_rank.sum()) == int(reps.sum())
    if P == 8:
        assert res.n_steals > 0
        if grid != "random":                  # a skew that stealing evens
            assert res.imbalance < float(reps.sum(axis=1).max()
                                         / reps.sum(axis=1).mean())
    else:
        assert res.n_steals == 0


@pytest.mark.parametrize("name", [n for n in USECASES if n != "wordcount"])
def test_stealing_usecases_equal_the_unstolen_job(data, name):
    reps = _reps("unbalanced", 8)
    got = core.submit(_cfg(8, "segmented", name=name), data, device="cpu",
                      repeats=reps).result()
    want = core.submit(core.JobConfig(usecase(core, name), task_size=TASK,
                                      push_cap=CAP, n_procs=8, segment=SEG),
                       data, device="cpu", repeats=reps).result()
    assert got.records == want.records == _oracle(data, name)
    assert got.n_steals > 0


def test_balanced_grid_never_steals(data):
    res = core.submit(_cfg(8, "segmented"), data, device="cpu").result()
    assert res.records == core.wordcount_oracle(data, VOCAB)
    assert res.n_steals == 0
    assert_equal(res.work_per_rank, res.tasks_per_rank)


def test_carry_rows_at_each_segment_boundary_equal_the_replay(data):
    """After each step(): the carry's work row replicated on every rank
    and equal to the replay's so far; the cursor counts every step, idle
    ones included."""
    P, reps = 8, _reps("zipf", 8)
    h = core.submit(_cfg(P, "segmented"), data, device="cpu", repeats=reps)
    ids = shard_task_ids(plan_input(N, TASK, P))
    work, stolen = np.zeros(P, np.int32), np.zeros(P, np.int32)
    k, more = 0, True
    while more:
        more = h.step()
        s = steal.steal_schedule(*_padded(h.feed.task_ids_grid,
                                          h.feed.repeats_grid, k, SEG),
                                 work0=work)
        work, stolen, k = s.work, stolen + s.stolen, k + SEG
        for row, want in ((h.carry.work, work), (h.carry.stolen, stolen)):
            assert_equal(row, np.broadcast_to(want, (P, P)))
        assert_equal(h.carry.cursor, np.full(P, k))
    assert k == -(-ids.shape[1] // SEG) * SEG
    h.close()


def holed_replan(h, seed):
    """Re-plan ``h``'s unread tasks onto a grid with -1 holes inside the
    rows of every rank, so that each rank's deque order differs from its
    columns; returns the grid."""
    rem = np.random.default_rng(seed).permutation(h.remaining_task_ids())
    P = h.spec.n_procs
    W = -(-len(rem) // P) + 3
    grid = np.full(P * W, -1, np.int32)
    at = np.random.default_rng(seed + 1).choice(P * W - P, len(rem),
                                                replace=False)
    grid[np.sort(at)] = rem
    grid = grid.reshape(P, W)
    assert ((grid[:, :-1] < 0) & (grid[:, 1:] >= 0)).any(axis=1).sum() > 1
    h.replan(grid)
    return grid


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_stealing_after_a_replan_with_holes_inside_rows(data, fused):
    """A stolen task is served from its owner's column: after a re-plan
    onto rows with holes inside them the records equal the oracle, and
    after each segment the carry's work and stolen rows (advanced by
    what the steps were given) equal the host replay of the new grid."""
    P, reps = 8, _reps("unbalanced", 8)
    h = core.submit(_cfg(P, "segmented", fused), data, device="cpu",
                    repeats=reps)
    h.step()
    work = h.carry.work[0].numpy().copy()
    stolen = h.carry.stolen[0].numpy().copy()
    holed_replan(h, seed=7)
    k, more, steals = SEG, True, 0
    while more:
        more = h.step()
        s = steal.steal_schedule(*_padded(h.feed.task_ids_grid,
                                          h.feed.repeats_grid, k, SEG),
                                 work0=work)
        work, stolen, k = s.work, stolen + s.stolen, k + SEG
        steals += s.n_stolen
        for row, want in ((h.carry.work, work), (h.carry.stolen, stolen)):
            assert_equal(row, np.broadcast_to(want, (P, P)))
    assert steals > 0
    res = h.result()
    assert res.records == core.wordcount_oracle(data, VOCAB)
    assert int(res.work_per_rank.sum()) == int(reps.sum())


class _EagerGraph:
    """A captured step replayed eagerly: the body on the static inputs."""

    def __init__(self, graphs, max_rep):
        self.graphs, self.max_rep = graphs, max_rep

    def replay(self):
        g = self.graphs
        onesided._fused_step_into(g.spec, g.map_fn, g.carry, *g.inputs,
                                  self.max_rep)


@pytest.mark.parametrize("P", [1, 8])
def test_stealing_through_step_graphs_equals_the_eager_loop(data, P,
                                                            monkeypatch):
    """The stealing job through ``StepGraphs`` (capture replaced by an
    eager replay of the captured body): one replay and one counted launch
    a step, and after each segment the eager loop's whole carry."""
    def capture(self, max_rep):
        self.graphs[max_rep] = _EagerGraph(self, max_rep)
        return self.graphs[max_rep]

    monkeypatch.setattr(onesided.StepGraphs, "_capture", capture)
    monkeypatch.setattr(fused_map, "launches", 0)
    reps = _reps("unbalanced", P)
    graph_job = core.submit(_cfg(P, "segmented", fused=True), data,
                            device="cpu", repeats=reps)
    fns = graph_job.engine
    graphs = fns.graphs = onesided.StepGraphs(fns.spec, fns.map_fn,
                                              graph_job.carry)
    eager_job = core.submit(_cfg(P, "segmented", fused=True), data,
                            device="cpu", repeats=reps)
    more = True
    while more:
        more = graph_job.step()
        eager_job.step()
        for f, a, b in zip(graph_job.carry._fields, graph_job.carry,
                           eager_job.carry):
            assert_equal(a, b, f)
    steps = -(-reps.shape[1] // SEG) * SEG
    assert graphs.replays == steps == fused_map.launches
    res = graph_job.result()
    assert res.records == eager_job.result().records == \
        core.wordcount_oracle(data, VOCAB)


def test_blocking_run_job_steals(data):
    from repro_torch.core.planner import gather_segment
    from repro_torch.data.source import ArraySource
    P = 8
    plan = plan_input(N, TASK, P)
    ids = shard_task_ids(plan)
    reps = _reps("unbalanced", P)
    spec = core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP,
                        n_procs=P, stealing=True)
    keys, vals = onesided.run_job(
        spec, core.as_map_fn(core.WordCount(VOCAB)), "cpu",
        gather_segment(ArraySource(data), plan, ids), ids, reps)
    valid = keys != 2**31 - 1
    assert dict(zip(keys[valid].tolist(), vals[valid].tolist())) == \
        core.wordcount_oracle(data, VOCAB)


# ---------------------------------------------------------------------------
# checkpoints, guards, the coarse outer loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_stealing_checkpoint_restores_and_finishes_exactly(tmp_path, data,
                                                           fused):
    reps = _reps("unbalanced", 8)
    cfg = _cfg(8, "segmented", fused)
    want = core.submit(cfg, data, device="cpu", repeats=reps).result()
    h = core.submit(cfg, data, device="cpu", repeats=reps)
    h.step(2)
    mgr = CheckpointManager(str(tmp_path))
    h.checkpoint(mgr)
    mgr.wait()
    assert np.asarray(h.carry.work).any()          # claim state is live
    h.close()
    b = core.submit(cfg, data, device="cpu", repeats=reps)
    b.step()                                        # a carry ahead of it
    b.restore(mgr)
    assert b.cursor == 2 * SEG
    res = b.result()
    assert res.records == want.records
    assert_equal(res.work_per_rank, want.work_per_rank)
    assert_equal(res.steals_per_rank, want.steals_per_rank)


@pytest.mark.parametrize("saved,into", [(True, False), (False, True)])
def test_restore_rejects_a_stealing_mismatch(tmp_path, data, saved, into):
    cfg = dict(task_size=TASK, push_cap=CAP, n_procs=8, segment=SEG)
    h = core.submit(core.JobConfig(core.WordCount(VOCAB), stealing=saved,
                                   **cfg), data, device="cpu")
    h.step()
    mgr = CheckpointManager(str(tmp_path))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    other = core.submit(core.JobConfig(core.WordCount(VOCAB), stealing=into,
                                       **cfg), data, device="cpu")
    with pytest.raises(ValueError, match="stealing"):
        other.restore(mgr)
    other.close()


def test_stealing_restore_rejects_a_partitioner_mismatch(tmp_path, data):
    h = core.submit(_cfg(8, "segmented"), data, device="cpu")
    h.step()
    mgr = CheckpointManager(str(tmp_path))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    other = core.submit(_cfg(8, "segmented", partitioner="sampled"), data,
                        device="cpu")
    with pytest.raises(ValueError, match="partitioner"):
        other.restore(mgr)
    other.close()


def test_stealing_on_2s_raises(data):
    cfg = core.JobConfig(core.WordCount(VOCAB), backend="2s", task_size=TASK,
                         push_cap=CAP, n_procs=8, stealing=True)
    with pytest.raises(ValueError, match="work stealing"):
        core.submit(cfg, data, device="cpu")
    assert not hasattr(core.get_backend("2s"), "supports_stealing")
    assert core.get_backend("1s").supports_stealing


@pytest.mark.parametrize("drift", [1.5, 3.0])
def test_outer_rebalance_on_a_live_stealing_handle_equals_jax(data, drift):
    """The coarse loop over stealing: with the default threshold (2.0
    under stealing) a drift below it leaves the handle alone and one above
    re-plans, as the reference's function decides on the same handle;
    the re-planned stealing job stays exact."""
    reps = _reps("unbalanced", 8)
    handles = [core.submit(_cfg(8, "segmented"), data, device="cpu",
                           repeats=reps) for _ in range(2)]
    grids = []
    for h, mod in zip(handles, (straggler, jstraggler)):
        h.step()
        tr = mod.ThroughputTracker(n_procs=8, alpha=1.0)
        tr.update(np.where(np.arange(8) == 0, drift, 1.0))
        grids.append(mod.outer_rebalance(h, tr))
    if drift < 2.0:
        assert grids == [None, None]
    else:
        assert_equal(grids[0], grids[1])
        assert (grids[0][0] >= 0).sum() < (grids[0][1] >= 0).sum()
    for h in handles:
        res = h.result()
        assert res.records == core.wordcount_oracle(data, VOCAB)
        assert int(res.work_per_rank.sum()) == int(reps.sum())
