"""The fused step that the card replays as a CUDA graph, run on the CPU.

``onesided._fused_step_into`` (the body a graph captures: it writes the
window, the pending chunk and the cursor into the carry's own buffers)
must equal ``_step``'s functional fused carry after every step, and the
job built from it must give the JAX package's records (its unfused
engine: the reference's fused job does not trace under the installed
jax). ``StepGraphs`` runs here with its capture replaced by an eager
replay of that body, which exercises its packed input buffer, one graph
for each distinct ``max_rep`` and its launch count. P in {1, 4, 8}, mixed
repeats, and a last segment whose padding changes ``max_rep``. Tolerance
0 (int32 path).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import onesided  # noqa: E402
from repro_torch.core.planner import plan_input, shard_task_ids  # noqa: E402
from repro_torch.data.feed import SegmentFeed  # noqa: E402
from repro_torch.data.source import ArraySource  # noqa: E402
from repro_torch.kernels.fused_map.ops import fused_map  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

VOCAB, N, TASK, CAP, SEGMENT = 300, 5000, 64, 8, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    return (rng.zipf(1.3, N) % VOCAB).astype(np.int32)


def _reps(P):
    """Rank 0 at rep 3 in every column, the others 1-3: every full column
    has max_rep 3, and the last segment's padding columns max_rep 1."""
    T = -(-(-(-N // TASK)) // P)
    reps = np.random.default_rng(P).integers(1, 4, (P, T)).astype(np.int32)
    reps[0] = 3
    return reps


def _job(P):
    spec = core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP,
                        n_procs=P, segment=SEGMENT, fused_map=True)
    plan = plan_input(N, TASK, P)
    return spec, plan, shard_task_ids(plan)


@pytest.fixture(scope="module")
def jax_records(data):
    """The JAX package's unfused job over the same corpus (its records do
    not depend on P or on the repeats)."""
    cfg = jcore.JobConfig(jcore.WordCount(VOCAB), task_size=TASK,
                          push_cap=CAP, n_procs=1, segment=SEGMENT)
    return jcore.submit(cfg, data).result().records


@pytest.mark.parametrize("P", [1, 4, 8])
def test_inplace_step_equals_step_and_jax(data, jax_records, P):
    reps = _reps(P)
    spec, plan, ids = _job(P)
    map_fn = core.as_map_fn(core.WordCount(VOCAB))
    feed = SegmentFeed(ArraySource(data), plan, ids, reps, segment=SEGMENT,
                       device="cpu", prefetch=False)
    functional = onesided.init_carry(spec, "cpu")
    inplace = onesided.init_carry(spec, "cpu")
    buffers = [t.data_ptr() for t in inplace]
    seen = []
    while (seg := feed.next_segment()) is not None:
        for c, m in enumerate(seg.max_rep.tolist()):
            args = (seg.tokens[:, c].contiguous(), seg.task_ids[:, c].clone(),
                    seg.repeats[:, c].clone(), m)
            functional = onesided._step(spec, map_fn, functional, *args)
            onesided._fused_step_into(spec, map_fn, inplace, *args)
            for f, a, b in zip(functional._fields, inplace, functional):
                assert_equal(a, b, f"step {len(seen)}: carry.{f}")
            seen.append(m)
    assert [t.data_ptr() for t in inplace] == buffers   # written in place
    assert set(seen) == {1, 3} and seen[-1] == 1         # max_rep changes
    keys, vals, _ = onesided._finish(spec, inplace)
    keys, vals = keys[0].numpy(), vals[0].numpy()
    valid = keys != 2**31 - 1
    records = dict(zip(keys[valid].tolist(), vals[valid].tolist()))
    assert records == jax_records == core.wordcount_oracle(data, VOCAB)


class _EagerGraph:
    """A captured step replayed eagerly: the body on the static inputs."""

    def __init__(self, graphs, max_rep):
        self.graphs, self.max_rep = graphs, max_rep

    def replay(self):
        g = self.graphs
        onesided._fused_step_into(g.spec, g.map_fn, g.carry, *g.inputs,
                                  self.max_rep)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_step_graphs_replay_the_job(data, jax_records, P, monkeypatch):
    """A job through ``submit`` whose segments go through StepGraphs (the
    capture replaced by an eager replay): one graph for each distinct
    max_rep, one replay and one counted launch for each step, the carry's
    buffers written in place, windows and records equal to the eager
    job's."""
    captured = []

    def capture(self, max_rep):
        captured.append(max_rep)
        self.graphs[max_rep] = _EagerGraph(self, max_rep)
        return self.graphs[max_rep]

    monkeypatch.setattr(onesided.StepGraphs, "_capture", capture)
    monkeypatch.setattr(fused_map, "launches", 0)
    reps = _reps(P)
    cfg = core.JobConfig(core.WordCount(VOCAB), task_size=TASK, push_cap=CAP,
                         n_procs=P, segment=SEGMENT, fused_map=True)
    graph_job = core.submit(cfg, data, device="cpu", repeats=reps)
    fns = graph_job.engine
    assert fns.graphs is None                 # the CPU runs the eager loop
    graphs = fns.graphs = onesided.StepGraphs(fns.spec, fns.map_fn,
                                              graph_job.carry)
    eager_job = core.submit(cfg, data, device="cpu", repeats=reps)
    graph_job.step()
    eager_job.step()
    assert_equal(graph_job.windows(), eager_job.windows())
    assert graphs.carry is graph_job.carry
    steps = graph_job.feed.total_columns
    steps += -steps % SEGMENT
    res = graph_job.result()
    assert fns.graphs is None                 # released with the job
    assert captured == [3, 1]                 # the last segment's padding
    assert graphs.replays == steps == fused_map.launches
    assert res.records == eager_job.result().records == jax_records


def test_fused_job_at_the_jobconfig_defaults_equals_jax():
    """A P 2 fused job at JobConfig's own defaults (S 4,096, cap 1,024,
    oneshot), past the 1,024 the kernel once stopped at, on a small Zipf
    corpus with mixed repeats: its records equal the JAX package's
    unfused job's and the oracle's."""
    vocab, n = 2000, 2 * 4096 * 5 - 123          # 5 steps, a short task
    data = (np.random.default_rng(11).zipf(1.3, n) % vocab).astype(np.int32)
    cfg = core.JobConfig(core.WordCount(vocab), n_procs=2, fused_map=True)
    assert (cfg.task_size, cfg.push_cap, cfg.segment) == (4096, 1024, 0)
    reps = np.random.default_rng(12).integers(1, 4, (2, 5)).astype(np.int32)
    got = core.submit(cfg, data, device="cpu", repeats=reps).result()
    want = jcore.submit(jcore.JobConfig(jcore.WordCount(vocab), n_procs=1),
                        data).result().records
    assert got.records == want == core.wordcount_oracle(data, vocab)
    assert got.n_tasks == 10
    assert got.work_per_rank.tolist() == reps.sum(axis=1).tolist()
