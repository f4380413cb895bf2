"""Tests of the port that need the card (marker ``cuda``).

They skip where no CUDA card is present, and they import no JAX, so the
GPU host can run them on their own:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from repro_torch.core import JobConfig, WordCount, submit  # noqa: E402
from repro_torch.core import wordcount_oracle  # noqa: E402
from repro_torch.core.planner import gather_segment  # noqa: E402
from repro_torch.data.feed import SegmentFeed  # noqa: E402
from repro_torch.data.source import ZipfSource  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.fused_map import ops  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops as sl_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.wordcount_hash import ops as wc_ops  # noqa: E402
from torch_parity import assert_equal, cuda_device, to_torch  # noqa: E402,F401


@pytest.mark.cuda
def test_card_is_sm90(cuda_device):
    assert torch.cuda.get_device_capability(cuda_device) == (9, 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,compute_cap",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    assert "9.0" in smi, smi


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(cuda_device):
    """Bit for bit on every output of every matrix case, near-SAT at
    rep > 1 and the full-width shapes included."""
    assert chip_smoke.phase_kernel_vs_plain(
        cuda_device, chip_smoke.fused_matrix()) == 0.0


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_wide_matrix(cuda_device):
    """Bit for bit at task sizes 1,025-16,384: each side of every change
    of the kernel's block, the global scratch past S 4,096 included."""
    assert chip_smoke.phase_kernel_vs_plain(
        cuda_device, chip_smoke.fused_wide_matrix()) == 0.0


def _wide_graph_job(cuda_device, S: int, n: int, reps_seed: int):
    """A fused job at task size ``S`` (P 8, cap 1024, V 65,536: fig9's
    width), segment 2, mixed repeats, on the card and on the CPU: its
    graphs, its fused_map launches, and both runs' records."""
    from repro_torch.data.corpus import synth_corpus
    data = synth_corpus(n, 65536, seed=7)
    cfg = JobConfig(WordCount(vocab=65536), task_size=S, push_cap=1024,
                    n_procs=8, segment=2, fused_map=True)
    T = -(-(-(-n // S)) // 8)
    reps = np.random.default_rng(reps_seed).integers(
        1, 4, (8, T)).astype(np.int32)
    before = ops.fused_map.launches
    gpu = submit(cfg, data, device=cuda_device, repeats=reps)
    gpu.step()
    graphs = gpu.engine.graphs
    while gpu.step():
        pass
    torch.cuda.synchronize()
    launches = ops.fused_map.launches - before
    cpu = submit(cfg, data, device="cpu", repeats=reps).result()
    return graphs, launches, gpu.result(), cpu, wordcount_oracle(data, 65536)


@pytest.mark.cuda
def test_fused_graph_job_at_the_default_task_size(cuda_device):
    """JobConfig's default S 4,096 on the card: one graph replay and one
    fused_map launch a step, records equal to its CPU run's."""
    graphs, launches, gpu, cpu, oracle = _wide_graph_job(
        cuda_device, 4096, 8 * 4096 * 6 - 100, 8)
    assert graphs.replays == launches == 6
    assert gpu.records == cpu.records == oracle


@pytest.mark.cuda
def test_fused_graph_job_at_s16384_sorts_in_the_global_scratch(
        cuda_device):
    """S 16,384 (fig8's largest task): its passes sort in the scratch
    that ``prepare`` made before the capture, and the job equals its CPU
    run."""
    graphs, launches, gpu, cpu, oracle = _wide_graph_job(
        cuda_device, 16384, 8 * 16384 * 4, 9)
    assert graphs.replays == launches == 4
    assert (cuda_device, 8 * 6 * 32768) in ops._SCRATCH   # 6 NP a rank
    assert gpu.records == cpu.records == oracle


@pytest.mark.cuda
def test_cuda_wrapper_launches_and_never_takes_plain(cuda_device,
                                                     monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops, "fused_step_ref", plain)
    args, P, cap = dict(chip_smoke.fused_matrix())["sweep1"]
    a = {k: to_torch(v).to(cuda_device) for k, v in args.items()}
    before = ops.fused_map.launches
    table, bk, _, counts = ops.fused_map(**a, n_procs=P, cap=cap)
    torch.cuda.synchronize()
    assert ops.fused_map.launches == before + 1
    assert table is a["table"] and bk.is_cuda and counts.shape == (P, P)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_cuda_feed_equals_host_reads(cuda_device, prefetch):
    """Every segment that crosses the pinned double buffer equals the
    host read of the same tasks, with the consumer's stream busy so the
    copies and buffer refills really overlap."""
    from repro_torch.core.planner import plan_input, shard_task_ids
    src = ZipfSource(1 << 18, vocab=5000, seed=1)
    plan = plan_input(src.len_elements(), 64, 4)
    ids = shard_task_ids(plan)
    reps = np.ones_like(ids)
    feed = SegmentFeed(src, plan, ids, reps, segment=16, device=cuda_device,
                       prefetch=prefetch)
    busy = torch.randn(2048, 2048, device=cuda_device)
    start = 0
    try:
        while (seg := feed.next_segment()) is not None:
            busy = busy @ busy.t() / 2048        # keep the stream busy
            want = gather_segment(src, plan, np.pad(
                ids[:, start:start + 16],
                ((0, 0), (0, max(0, start + 16 - ids.shape[1]))),
                constant_values=-1))
            assert_equal(seg.tokens, want)
            assert_equal(seg.task_ids[:, :min(16, ids.shape[1] - start)],
                         ids[:, start:start + 16])
            start += 16
    finally:
        feed.close()
    assert start >= ids.shape[1]
    if prefetch:
        assert feed.stats.prefetch_hits == feed.stats.segments_built - 1


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_job_on_card_equals_cpu(cuda_device, fused):
    data = np.random.default_rng(3).integers(0, 700, 1 << 15).astype(
        np.int32)
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=4, fused_map=fused)
    reps = np.random.default_rng(4).integers(1, 4, (8, 32)).astype(np.int32)
    gpu = submit(cfg, data, device=cuda_device, repeats=reps)
    gpu.step()
    cpu = submit(cfg, data, device="cpu", repeats=reps)
    cpu.step()
    assert_equal(gpu.windows(), cpu.windows())
    assert gpu.result().records == cpu.result().records == \
        wordcount_oracle(data, 700)


@pytest.mark.cuda
def test_fused_job_replays_one_graph_a_step(cuda_device, monkeypatch):
    """The fused job through ``submit`` on the card replays a CUDA graph
    for every step: one graph for each distinct max_rep (the last
    segment's padding changes it), replays == steps == fused_map
    launches, the carry written in place; windows and records equal to
    the CPU's."""
    from repro_torch.core.onesided import StepGraphs
    data = np.random.default_rng(5).integers(0, 700, 30_000).astype(
        np.int32)
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=7, fused_map=True)
    reps = np.random.default_rng(6).integers(1, 4, (8, 30)).astype(np.int32)
    reps[0] = 3            # max_rep 3, then 1 on the last segment's padding
    monkeypatch.setattr(ops.fused_map, "launches", 0)
    gpu = submit(cfg, data, device=cuda_device, repeats=reps)
    cpu = submit(cfg, data, device="cpu", repeats=reps)
    gpu.step()
    cpu.step()
    graphs = gpu.engine.graphs
    assert isinstance(graphs, StepGraphs)
    assert graphs.carry is gpu.carry
    buffers = [t.data_ptr() for t in gpu.carry]
    assert_equal(gpu.windows(), cpu.windows())
    while gpu.step():
        pass
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in gpu.carry] == buffers
    assert sorted(graphs.graphs) == [1, 3]
    assert graphs.replays == 35 == ops.fused_map.launches
    assert ops.fused_map.captured >= 2
    assert gpu.result().records == cpu.result().records == \
        wordcount_oracle(data, 700)
    assert gpu.engine.graphs is None                   # released


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["restore", "load"])
def test_restore_into_captured_step_graphs_finishes_exact(cuda_device,
                                                          tmp_path, how):
    """A snapshot installed into a fused job whose step graphs are
    already captured lands in the buffers the graphs replay into: the job
    finishes with the uninterrupted job's records, and a snapshot taken
    on the card holds the carry of its call."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.windows import carry_to_numpy
    data = np.random.default_rng(8).integers(0, 700, 30_000).astype(
        np.int32)
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=5, fused_map=True)
    reps = np.random.default_rng(9).integers(1, 4, (8, 30)).astype(np.int32)
    want = submit(cfg, data, device=cuda_device,
                  repeats=reps).result().records
    a = submit(cfg, data, device=cuda_device, repeats=reps)
    a.step(2)
    mgr = CheckpointManager(str(tmp_path))
    fut = a.checkpoint(mgr)
    snap = carry_to_numpy(a.carry)
    a.step()                             # folds in place before the write
    fut.result(timeout=120)
    b = submit(cfg, data, device=cuda_device, repeats=reps)
    b.step(4)                            # its graphs captured, carry ahead
    buffers = [t.data_ptr() for t in b.carry]
    if how == "restore":
        b.restore(mgr)
    else:
        b.load(snap, 10)
    assert b.cursor == 10 and b.engine.graphs.carry is b.carry
    assert [t.data_ptr() for t in b.carry] == buffers
    for x, y in zip(carry_to_numpy(b.carry), snap):
        assert_equal(x, y)
    assert b.result().records == want == wordcount_oracle(data, 700)
    assert a.result().records == want


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["1s", "2s"])
def test_both_backends_on_the_card_equal_the_cpu(cuda_device, backend):
    """``"2s"`` (and ``"1s"``, fused) on the card: the CPU's windows after
    a segment, the oracle's records."""
    data = np.random.default_rng(10).integers(0, 700, 1 << 15).astype(
        np.int32)
    cfg = JobConfig(WordCount(vocab=700), backend=backend, task_size=128,
                    push_cap=16, n_procs=8, segment=4,
                    fused_map=backend == "1s")
    reps = np.random.default_rng(11).integers(1, 4, (8, 32)).astype(
        np.int32)
    gpu = submit(cfg, data, device=cuda_device, repeats=reps)
    cpu = submit(cfg, data, device="cpu", repeats=reps)
    gpu.step()
    cpu.step()
    assert_equal(gpu.windows(), cpu.windows())
    assert gpu.result().records == cpu.result().records == \
        wordcount_oracle(data, 700)


def _steal_job(device, eager=False, partitioner="hash", segment=4):
    """A fused stealing job with a hot rank at 8x, on ``device``; with
    ``eager`` the card runs its eager loop instead of the graphs."""
    data = np.random.default_rng(12).zipf(1.3, 1 << 15) % 700
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=segment, fused_map=True,
                    stealing=True, partitioner=partitioner)
    reps = np.ones((8, 32), np.int32)
    reps[0] = 8
    h = submit(cfg, data.astype(np.int32), device=device, repeats=reps)
    if eager:
        h.engine.graphs = None
    return h, data.astype(np.int32)


@pytest.mark.cuda
def test_stealing_graphs_equal_the_eager_stealing_loop(cuda_device,
                                                       monkeypatch):
    """The stealing job's graph replays on the card equal its eager loop
    on the card and the CPU's job bit for bit, carry field by field after
    every segment: one replay and one fused_map launch a step, the
    steals of the host replay, the records of the oracle."""
    from repro_torch.core.windows import carry_to_numpy
    monkeypatch.setattr(ops.fused_map, "launches", 0)
    graph, data = _steal_job(cuda_device)
    eager, _ = _steal_job(cuda_device, eager=True)
    cpu, _ = _steal_job("cpu")
    more = True
    while more:
        more = graph.step()
        eager.step()
        cpu.step()
        want = carry_to_numpy(cpu.carry)
        for got in (carry_to_numpy(graph.carry), carry_to_numpy(eager.carry)):
            for f, x, y in zip(want._fields, got, want):
                assert_equal(x, y, f)
    graphs = graph.engine.graphs
    assert graphs.replays == 32
    res = graph.result()
    assert res.records == eager.result().records == cpu.result().records \
        == wordcount_oracle(data, 700)
    assert res.n_steals > 0
    assert ops.fused_map.launches == 32 + 32      # graph + eager, one a step


@pytest.mark.cuda
def test_stealing_after_a_replan_with_holes_inside_rows_on_the_card(
        cuda_device):
    """A re-plan onto rows with -1 holes inside them (each rank's deque
    order then differs from its columns): the graph job on the card
    equals the CPU's job carry for carry after every segment, its work
    and stolen rows included, and its records equal the oracle."""
    from repro_torch.core.windows import carry_to_numpy
    (graph, data), (cpu, _) = _steal_job(cuda_device), _steal_job("cpu")
    for h in (graph, cpu):
        h.step()
        rem = np.random.default_rng(7).permutation(h.remaining_task_ids())
        W = -(-len(rem) // 8) + 3
        grid = np.full(8 * W, -1, np.int32)
        grid[np.sort(np.random.default_rng(8).choice(
            8 * W - 8, len(rem), replace=False))] = rem
        h.replan(grid.reshape(8, W))
    more = True
    while more:
        more = graph.step()
        cpu.step()
        want = carry_to_numpy(cpu.carry)
        for f, x, y in zip(want._fields, carry_to_numpy(graph.carry), want):
            assert_equal(x, y, f)
    assert graph.engine.graphs.replays > 0
    res = graph.result()
    assert res.n_steals > 0
    assert res.records == cpu.result().records == wordcount_oracle(data, 700)


@pytest.mark.cuda
@pytest.mark.parametrize("stealing", [False, True])
def test_a_sampled_map_installed_after_capture_routes_the_graphs(
        cuda_device, stealing):
    """A split map installed after the step graphs were captured is the
    map they route by: after a segment each rank's window holds the CPU
    job's records under that map (split keys included, picked by each
    task's global id), and not the hash map's."""
    from repro_torch.core import SampledPartitioner
    part = SampledPartitioner(sample_tasks=32, split=True,
                              split_threshold=0.05)
    data = (np.random.default_rng(13).zipf(1.6, 1 << 15) % 700).astype(
        np.int32)
    cfg = dict(task_size=128, push_cap=16, n_procs=8, segment=4,
               fused_map=True, stealing=stealing)
    reps = np.ones((8, 32), np.int32)
    reps[0] = 4
    jobs = {}
    for name, device, p in (("graph", cuda_device, part), ("cpu", "cpu", part),
                            ("hash", cuda_device, "hash")):
        h = jobs[name] = submit(JobConfig(WordCount(vocab=700),
                                          partitioner=p, **cfg), data,
                                device=device, repeats=reps)
        if name == "graph":
            h.engine.graphs._capture(4)     # captured on the hash seed
            assert h.engine.graphs.graphs
        h.step()
    assert jobs["graph"].engine.graphs.replays == 4
    assert int((jobs["graph"].carry.owner_split[0] > 1).sum()) > 0
    assert_equal(jobs["graph"].windows(), jobs["cpu"].windows())
    assert not np.array_equal(jobs["graph"].windows() != 0,
                              jobs["hash"].windows() != 0)
    res = jobs["graph"].result()
    assert res.n_split_keys > 0
    assert res.records == jobs["cpu"].result().records == \
        jobs["hash"].result().records == wordcount_oracle(data, 700)


@pytest.mark.cuda
def test_stealing_restore_into_captured_graphs_finishes_exact(cuda_device,
                                                              tmp_path):
    """A stealing snapshot restored into a job whose graphs are captured
    and whose carry is ahead: the job finishes with the uninterrupted
    job's records, work row and steals."""
    from repro_torch.ckpt import CheckpointManager
    want = _steal_job(cuda_device)[0].result()
    a, _ = _steal_job(cuda_device)
    a.step(3)
    mgr = CheckpointManager(str(tmp_path))
    a.checkpoint(mgr).result(timeout=120)
    a.close()
    b, _ = _steal_job(cuda_device)
    b.step(5)
    buffers = [t.data_ptr() for t in b.carry]
    b.restore(mgr)
    assert b.cursor == 12 and [t.data_ptr() for t in b.carry] == buffers
    res = b.result()
    assert res.records == want.records
    assert_equal(res.work_per_rank, want.work_per_rank)
    assert_equal(res.steals_per_rank, want.steals_per_rank)


@pytest.mark.cuda
@pytest.mark.parametrize("usecase", ["Histogram(700, 13)",
                                     "InvertedIndex((3, 7, 11, 650), 4, 8)"])
def test_fused_usecases_replay_on_the_card(cuda_device, usecase):
    """Every built-in use-case's map can be captured: its fused job on the
    card (one graph replay a step) gives the CPU's windows and output."""
    from repro_torch import core
    data = np.random.default_rng(7).integers(0, 700, 1 << 14).astype(
        np.int32)
    uc = eval(usecase, vars(core))
    cfg = JobConfig(uc, task_size=128, push_cap=16, n_procs=8, segment=4,
                    fused_map=True)
    gpu = submit(cfg, data, device=cuda_device)
    cpu = submit(cfg, data, device="cpu")
    gpu.step()
    cpu.step()
    assert gpu.engine.graphs.replays == 4
    assert_equal(gpu.windows(), cpu.windows())
    assert gpu.result().records == cpu.result().records


@pytest.mark.cuda
def test_fused_job_raises_when_its_graph_cannot_be_captured(cuda_device,
                                                            tmp_path):
    """A map that syncs with the host cannot be captured: the job raises
    and launches nothing eagerly on the card. In a process of its own,
    so a failed capture leaves no state behind for the other tests."""
    script = tmp_path / "capture_fails.py"
    script.write_text(textwrap.dedent("""
        import numpy as np, torch
        from repro_torch.core import JobConfig, WordCount, submit
        from repro_torch.kernels.fused_map import ops

        class Syncing(WordCount):
            def map_emit(self, tokens, task_id):
                int(tokens.max())                # a host sync
                return super().map_emit(tokens, task_id)

        cfg = JobConfig(Syncing(vocab=300), task_size=64, push_cap=8,
                        n_procs=4, segment=2, fused_map=True)
        data = np.arange(4096, dtype=np.int32) % 300
        try:
            submit(cfg, data, device="cuda").result()
        except RuntimeError as e:
            print("RAISED", ops.fused_map.launches, str(e)[:200])
        else:
            print("NO ERROR")
    """))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(chip_smoke.ROOT, "src"),
         os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert "RAISED 0 " in proc.stdout, (proc.stdout, proc.stderr[-2000:])


# ---------------------------------------------------------------------------
# the multi-tenant scheduler on the card
# ---------------------------------------------------------------------------

class _RoundRobin:
    """A scheduler policy that slices the live jobs in turn."""
    name = "round-robin"

    def __init__(self):
        self.turn = 0

    def pick(self, candidates, tenants):
        self.turn += 1
        return candidates[(self.turn - 1) % len(candidates)]


@dataclasses.dataclass(frozen=True)
class _Boom:
    """A use-case whose map raises: the poisoned tenant."""
    vocab: int

    @property
    def window(self):
        return self.vocab

    def map_emit(self, tokens, task_id):
        raise ValueError("boom in the map")


def _fleet_jobs(n_jobs, seed=20):
    """(config, data, repeats, solo records on the card) of fused
    WordCount jobs of one spec over different data and grids."""
    cfg = JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                    n_procs=8, segment=4, fused_map=True)
    rng = np.random.default_rng(seed)
    jobs = []
    for k in range(n_jobs):
        data = rng.integers(0, 700, 128 * 8 * (12 + 4 * k)).astype(np.int32)
        reps = rng.integers(1, 4, (8, 12 + 4 * k)).astype(np.int32)
        jobs.append((cfg, data, reps))
    return jobs


def _solo(cfg, data, reps, device):
    res = submit(cfg, data, device=device, repeats=reps).result()
    assert res.records == wordcount_oracle(data, 700)
    return res.records


@pytest.mark.cuda
def test_two_fused_jobs_of_one_spec_interleave_exactly(cuda_device):
    """Two fused jobs of one spec sliced in turn, one segment at a time:
    one program, but each handle replays its own graphs into its own
    carry, and each job's records equal its solo run."""
    from repro_torch.core import JobScheduler
    jobs = _fleet_jobs(2)
    solo = [_solo(*j, cuda_device) for j in jobs]
    sched = JobScheduler(policy=_RoundRobin(), device=cuda_device)
    handles = [sched.submit(cfg, data, repeats=reps, name=f"j{k}")
               for k, (cfg, data, reps) in enumerate(jobs)]
    sched.run_until_complete(max_slices=4)
    g0, g1 = (h.engine.graphs for h in handles)
    assert g0 is not g1 and g0.replays == g1.replays == 8
    for h, g in zip(handles, (g0, g1)):
        assert [t.data_ptr() for t in g.carry] == \
            [t.data_ptr() for t in h.carry]
    res = sched.run_until_complete()
    assert sched.n_unique_programs == 1
    assert handles[0]._map_fn is handles[1]._map_fn
    for k in range(2):
        assert res[f"j{k}"].records == solo[k]


@pytest.mark.cuda
def test_fused_jobs_admitted_mid_fleet_capture_while_feeds_copy(
        cuda_device):
    """Four fused jobs under ``max_active=2``: the two admitted later
    capture their graphs while the live jobs' feeds stage copies on their
    side streams; every job equals its solo run, and each step is one
    graph replay (fused_map launches == the fleet's steps)."""
    from repro_torch.core import JobScheduler
    jobs = _fleet_jobs(4, seed=21)
    solo = [_solo(*j, cuda_device) for j in jobs]
    sched = JobScheduler(policy="fair", device=cuda_device, max_active=2)
    for k, (cfg, data, reps) in enumerate(jobs):
        sched.submit(cfg, data, repeats=reps, name=f"j{k}", tenant=f"t{k}")
    before = ops.fused_map.launches
    sched.run_until_complete(max_slices=2)
    assert [j.state for j in sched.jobs] == ["live", "live", "queued",
                                             "queued"]
    res = sched.run_until_complete()
    torch.cuda.synchronize()
    steps = sum(-(-reps.shape[1] // 4) * 4 for _, _, reps in jobs)
    assert ops.fused_map.launches - before == steps
    for k in range(4):
        assert res[f"j{k}"].records == solo[k]


@pytest.mark.cuda
def test_a_poisoned_fused_tenant_fails_alone(cuda_device):
    """A fused tenant whose map raises (in the step graph's warm-up,
    before any capture) fails alone: no capture left open, the current
    stream restored, its feed closed with its pinned pair given back,
    and both siblings equal their solo runs."""
    from repro_torch.core import JobScheduler
    from repro_torch.core.scheduler import FAILED
    jobs = _fleet_jobs(2, seed=22)
    solo = [_solo(*j, cuda_device) for j in jobs]
    stream = torch.cuda.current_stream(cuda_device)
    sched = JobScheduler(policy="fair", device=cuda_device)
    bad_cfg = JobConfig(_Boom(700), task_size=128, push_cap=16, n_procs=8,
                        segment=4, fused_map=True)
    hb = sched.submit(bad_cfg, jobs[0][1], name="bad", tenant="evil")
    for k, (cfg, data, reps) in enumerate(jobs):
        sched.submit(cfg, data, repeats=reps, name=f"j{k}", tenant=f"t{k}")
    res = sched.run_until_complete()
    assert sched["bad"].state == FAILED
    assert isinstance(sched["bad"].error, ValueError)
    assert not torch.cuda.is_current_stream_capturing()
    assert torch.cuda.current_stream(cuda_device) == stream
    assert hb.feed._closed and hb.feed._pinned is None
    assert set(res) == {"j0", "j1"}
    for k in range(2):
        assert res[f"j{k}"].records == solo[k]


@pytest.mark.cuda
def test_finished_and_queued_feeds_hold_no_pinned_pair(cuda_device):
    """Under ``max_active=1`` only the live job's feed holds its pinned
    pair (made at its first build); the queued jobs' hold none, and every
    feed has given its pair back once its job finished."""
    from repro_torch.core import JobScheduler
    jobs = _fleet_jobs(3, seed=23)
    sched = JobScheduler(policy="fifo", device=cuda_device, max_active=1)
    for k, (cfg, data, reps) in enumerate(jobs):
        sched.submit(cfg, data, repeats=reps, name=f"j{k}")
    sched.run_until_complete(max_slices=1)
    feeds = [j.handle.feed for j in sched.jobs]
    assert [f._pinned is None for f in feeds] == [False, True, True]
    n = 8 * 4 * (128 + 2) * 4
    assert [t.nbytes for t in feeds[0]._pinned] == [n, n]
    sched.run_until_complete()
    assert all(f._pinned is None and f._stream is None for f in feeds)
    assert all(j.state == "done" for j in sched.jobs)


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_the_card(cuda_device):
    """Every case of the smoke's flash_attention matrix (every width's
    own head dim and a narrower one it pads; bf16 through the
    tensor-core kernel, fp32 through the CUDA-core one), at its per-dtype
    tolerance (the helper raises on a miss)."""
    errs = chip_smoke.phase_flash_vs_plain(cuda_device,
                                           chip_smoke.FLASH_MATRIX)
    assert set(errs) == set(chip_smoke.FLASH_MATRIX)


@pytest.mark.cuda
def test_flash_kernel_matches_plain_at_full_width(cuda_device):
    """The served shapes of olmo-1b, h2o-danube-1.8b, jamba-v0.1,
    stablelm-12b, codeqwen1.5-7b and llama4-maverick, and h2o's heads at
    S 8192 with window 4096 (whole KV tiles skipped at full width)."""
    errs = chip_smoke.phase_flash_vs_plain(cuda_device,
                                           chip_smoke.FLASH_FULL)
    assert set(errs) == set(chip_smoke.FLASH_FULL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gqa4_f32", "gqa4_hd80_ragged333_bf16"])
def test_flash_wrapper_launches_and_never_takes_plain(cuda_device,
                                                      monkeypatch, name):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fa_ops, "flash_attention_plain", plain)
    q, k, v = chip_smoke.flash_inputs(chip_smoke.FLASH_MATRIX[name],
                                      cuda_device)
    before = fa_ops.flash_attention.launches
    o = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert o.is_cuda and o.shape == q.shape and o.dtype == q.dtype


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [18, 192])
def test_flash_kernel_rejects_other_head_dims(cuda_device, hd):
    """hd 18 is no multiple of 4 and 192 (MLA's) is past 160: no width
    of ``fa_ops.supported`` holds them."""
    assert fa_ops.supported(hd) is None
    q = torch.zeros(1, 64, 2, hd, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.cuda
def test_flash_kernel_rejects_unaligned_data(cuda_device):
    """The bf16 kernel's tensor maps need 16-byte aligned bases: a
    contiguous view two bytes in raises instead of being copied."""
    flat = torch.zeros(1 + 64 * 2 * 80, device=cuda_device,
                       dtype=torch.bfloat16)
    q = flat[1:].view(1, 64, 2, 80)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("attn_type,d_head", [("gqa", 64), ("swa", 64),
                                              ("swa", 80)])
def test_serving_on_the_card_equals_the_cpu(cuda_device, attn_type, d_head):
    """A small dense model in fp32 at head dim 64, and at h2o-danube-1.8b's
    80: greedy tokens served on the card equal those served on the CPU,
    and each prefill launched the kernel once per layer."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(
        get_smoke_config("h2o-danube-1.8b"), d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, d_head=d_head, attn_type=attn_type,
        sliding_window=48 if attn_type == "swa" else 0, dtype="float32",
        param_dtype="float32")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    model = init_model(cfg, 0, device="cpu")
    want = ServeEngine(cfg, model, max_len=120, device="cpu") \
        .generate(prompts, 8)
    model.to(cuda_device)                   # moves the weights in place
    before = fa_ops.flash_attention.launches
    got = ServeEngine(cfg, model, max_len=120, device=cuda_device) \
        .generate(prompts, 8)
    assert fa_ops.flash_attention.launches == before + cfg.n_layers
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_ssd_kernel_matches_plain_on_the_card(cuda_device):
    """Every case of SSD_MATRIX (the reference's sweep, ragged S, two
    groups, an overflowing decay), y and state at the reference's
    per-dtype tolerance (the helper raises on a miss)."""
    errs = chip_smoke.phase_ssd_vs_plain(cuda_device, chip_smoke.SSD_MATRIX)
    assert set(errs) == set(chip_smoke.SSD_MATRIX)


@pytest.mark.cuda
def test_ssd_bits_on_the_card(cuda_device):
    """Every bf16 case of SSD_MATRIX: the share of the kernel's y off
    ``ssd_plain``'s bits is below a quarter of the control's, whose
    decayed scores are rounded to bf16 (the helper raises on a miss)."""
    shares = chip_smoke.check_ssd_bits(cuda_device, chip_smoke.SSD_MATRIX)
    assert set(shares) == {n for n, c in chip_smoke.SSD_MATRIX.items()
                           if c[7] == "bfloat16"}


@pytest.mark.cuda
def test_ssd_wrapper_launches_and_never_takes_plain(cuda_device,
                                                    monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ssd_ops, "ssd_plain", plain)
    case = chip_smoke.SSD_MATRIX["g2_ragged320_bf16"]
    x, dt, A, B, C = chip_smoke.ssd_inputs(case, cuda_device)
    before = ssd_ops.ssd.launches
    y, st = ssd_ops.ssd(x, dt, A, B, C, chunk=case[6])
    torch.cuda.synchronize()
    assert ssd_ops.ssd.launches == before + 1
    assert y.is_cuda and y.shape == x.shape and y.dtype == x.dtype
    assert st.shape == (1, 8, 64, 32) and st.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["P128", "N64", "chunk24"])
def test_ssd_kernel_rejects_other_shapes(cuda_device, bad):
    P, N, chunk = {"P128": (128, 16, 64), "N64": (32, 64, 64),
                   "chunk24": (32, 16, 24)}[bad]
    assert not ssd_ops.supported(P, N, chunk)
    x = torch.zeros(1, 64, 2, P, device=cuda_device)
    dt = torch.zeros(1, 64, 2, device=cuda_device)
    A = torch.zeros(2, device=cuda_device)
    B = torch.zeros(1, 64, 1, N, device=cuda_device)
    with pytest.raises(ValueError, match="ssd_scan kernel takes"):
        ssd_ops.ssd(x, dt, A, B, B, chunk=chunk)


@pytest.mark.cuda
def test_ssm_serving_on_the_card_equals_the_cpu(cuda_device):
    """A small mamba2 model (P = 32, N = 16, chunk 64, so the kernel
    takes it; 100-token prompts, so the last chunk is ragged) in fp32:
    greedy tokens served on the card equal those served on the CPU, and
    each prefill launched the kernel once per layer."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(
        get_smoke_config("mamba2-780m"), d_model=128, ssm_head_dim=32,
        ssm_state=16, ssm_chunk=64, dtype="float32", param_dtype="float32")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    model = init_model(cfg, 0, device="cpu")
    want = ServeEngine(cfg, model, max_len=120, device="cpu") \
        .generate(prompts, 8)
    model.to(cuda_device)                   # moves the weights in place
    before = ssd_ops.ssd.launches
    got = ServeEngine(cfg, model, max_len=120, device=cuda_device) \
        .generate(prompts, 8)
    assert ssd_ops.ssd.launches == before + cfg.n_layers
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_ssd_bf16_serving_on_the_card(cuda_device):
    """A 2-layer mamba2 model in bf16 at the served head and state widths
    (P 64, N 128; chunk 64 and 200-token prompts, so the last chunk is
    ragged): a prefill through the tensor-core kernel launches it once per
    layer, and its last-position logits keep ``ssm_drift``'s rule against
    the same weights in fp32: the fp32 kernel path within 1e-3 *
    max|logits| of the fp32 reference path, and the bf16 kernel path no
    more than SSM_DRIFT_FACTOR times as far from it as the bf16 reference
    path."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"), d_model=256,
                              ssm_head_dim=64, ssm_state=128, ssm_chunk=64)
    assert cfg.n_layers == 2 and cfg.dtype == "bfloat16"
    model = tf.init_model(cfg, 0, device=cuda_device)
    tokens = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda_device)}
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    with torch.inference_mode():
        before = ssd_ops.ssd.launches
        lk = tf.prefill(cfg, model, tokens, use_kernel=True)[:, 0].float()
        torch.cuda.synchronize()
        assert ssd_ops.ssd.launches == before + cfg.n_layers
        lr = tf.prefill(cfg, model, tokens, use_kernel=False)[:, 0].float()
        drift = chip_smoke.ssm_drift(cfg32, copy.deepcopy(model).float(),
                                     tokens, lk, lr)
    assert drift["fp32_err_over_limit"] <= 1.0
    assert (drift["kernel_low_vs_fp32"]
            <= chip_smoke.SSM_DRIFT_FACTOR * drift["ref_low_vs_fp32"])


@pytest.mark.cuda
def test_fused_kernel_refuses_task_sizes_past_its_limit(cuda_device):
    """Above MAX_TASK_SIZE (16,384) only the plain version computes the
    step (on the CPU); a CUDA tensor raises instead of taking it."""
    args, P, cap = chip_smoke.fused_case(17, 2, ops.MAX_TASK_SIZE + 1, 512,
                                         8, 1)
    a = {k: to_torch(v).to(cuda_device) for k, v in args.items()}
    with pytest.raises(ValueError, match="task sizes up to"):
        ops.fused_map(**a, n_procs=P, cap=cap)


@pytest.mark.cuda
def test_entry_point_kernels_match_plain_on_the_card(cuda_device):
    """hist and bucket_slots bit for bit, flash_decode at its tolerance,
    over their whole matrices and the served caches in fp32 (the helpers
    raise on a miss)."""
    matrix = chip_smoke.matrix_cases(cuda_device, decode={
        **chip_smoke.DECODE_MATRIX, **chip_smoke.DECODE_FULL_F32})
    errs = chip_smoke.check_cases(matrix)
    chip_smoke.check_decode_edges(matrix)
    assert len(errs) == len(matrix)


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [64, 256, 4096])
def test_flash_decode_block_kv_changes_the_plan_not_the_result(cuda_device,
                                                               block_kv):
    case = chip_smoke.DECODE_FULL_F32["olmo-1b_f32"]
    c = chip_smoke.decode_case(case, cuda_device)
    q, k, v, t = c["args"]
    got = fd_ops.flash_decode(q, k, v, t, block_kv=block_kv)
    chip_smoke._check_decode(f"block_kv {block_kv}", got, c["plain"](),
                             case[6])


@pytest.mark.cuda
def test_flash_decode_fills_one_wave_and_resets_its_counters(cuda_device):
    """At both served caches the grid is one wave of the CTAs the card
    holds, and after calls that combine splits the per-head counters are
    back at 0, ready for the next call."""
    for arch, case in chip_smoke.DECODE_FULL.items():
        q, k, v = chip_smoke.decode_inputs(case, cuda_device)
        plan = fd_ops.plan(q, k)
        assert plan["splits"] > 1, (arch, plan)
        assert plan["ctas"] <= plan["ctas_per_sm"] * plan["sms"], plan
        for _ in range(3):
            fd_ops.flash_decode(q, k, v, case[5])
    torch.cuda.synchronize()
    for count, _ in fd_ops._SCRATCH.values():
        assert int(count.abs().sum()) == 0


@pytest.mark.cuda
def test_entry_point_wrappers_launch_and_never_take_plain(cuda_device,
                                                          monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(wc_ops, "hist_plain", plain)
    monkeypatch.setattr(sl_ops, "bucket_slots_ref", plain)
    monkeypatch.setattr(fd_ops, "flash_decode_plain", plain)
    case = chip_smoke.HIST_MATRIX["wide_owner8"]
    tokens = to_torch(chip_smoke.hist_tokens(case)).to(cuda_device)
    ids = to_torch(chip_smoke.slot_ids(
        chip_smoke.SLOTS_MATRIX["invalid"])).to(cuda_device)
    dcase = chip_smoke.DECODE_MATRIX["g4_hd80_bf16"]
    q, k, v = chip_smoke.decode_inputs(dcase, cuda_device)
    before = [f.launches for f in (wc_ops.wordcount_hist,
                                   sl_ops.bucket_slots, fd_ops.flash_decode)]
    hist = wc_ops.wordcount_hist(tokens, case[1], case[2])
    slots, counts = sl_ops.bucket_slots(ids, 16)
    o = fd_ops.flash_decode(q, k, v, torch.tensor(
        dcase[5], dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    after = [f.launches for f in (wc_ops.wordcount_hist,
                                  sl_ops.bucket_slots, fd_ops.flash_decode)]
    assert after == [b + 1 for b in before]
    assert hist.is_cuda and hist.shape == (case[1],)
    assert slots.is_cuda and counts.shape == (16,)
    assert o.is_cuda and o.shape == q.shape and o.dtype == q.dtype


def _slot_case(case, device):
    ids = to_torch(chip_smoke.slot_ids(case)).to(device)
    return ids, case[1], sl_ops.bucket_slots_ref(ids, case[1])


def _assert_slots(got, want, what=""):
    assert_equal(got[0], want[0].cpu().numpy(), f"{what} slots")
    assert_equal(got[1], want[1].cpu().numpy(), f"{what} counts")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.SLOTS_LOOKBACK))
def test_bucket_slots_looks_back_over_many_tiles(cuda_device, name):
    """Cases whose look-back over earlier tiles takes several rounds, bit
    for bit with the plain version."""
    ids, E, want = _slot_case(chip_smoke.SLOTS_LOOKBACK[name], cuda_device)
    _assert_slots(sl_ops.bucket_slots(ids, E), want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["routing", "owner_window"])
def test_bucket_slots_is_one_device_kernel_a_call(cuda_device, shape):
    """At both full-width shapes a call is one device activity: no fill,
    no second pass."""
    T, E = chip_smoke.ROUTING if shape == "routing" else (
        chip_smoke.N_PROCS * chip_smoke.SEGMENT * chip_smoke.TASK,
        chip_smoke.N_PROCS)
    ids = to_torch(np.random.default_rng(T).integers(0, E, T).astype(
        np.int32)).to(cuda_device)
    _, names, per_call = chip_smoke._device_ms(
        lambda: sl_ops.bucket_slots(ids, E), 50)
    # a trace can drop activities, never add one
    assert len(names) == 1 and 0 < per_call <= 1.0, (names, per_call)
    _assert_slots(sl_ops.bucket_slots(ids, E),
                  sl_ops.bucket_slots_ref(ids, E), shape)


@pytest.mark.cuda
def test_bucket_slots_calls_in_a_row_agree(cuda_device):
    """Ten calls in a row on one stream, and calls of other shapes between
    them on the same scratch (which grows, and keeps the words of larger
    calls), each equal to the plain version: every call's epoch leaves
    the status words ready for the next."""
    cases = [_slot_case(chip_smoke.SLOTS_MATRIX[n], cuda_device) for n in
             ("repeat_across_tiles", "T2049", "E256_eight_tiles", "T1")]
    cases.append(_slot_case(chip_smoke.SLOTS_LOOKBACK["lookback_E64"],
                            cuda_device))
    ids, E, want = cases[0]
    outs = [sl_ops.bucket_slots(ids, E) for _ in range(10)]
    for i, got in enumerate(outs):
        _assert_slots(got, want, f"call {i}")
    for _ in range(3):
        for ids, E, want in cases + cases[::-1]:
            _assert_slots(sl_ops.bucket_slots(ids, E), want, f"E {E}")


@pytest.mark.cuda
def test_bucket_slots_on_two_streams(cuda_device):
    """Calls on two CUDA streams, interleaved: each stream keeps its own
    scratch, and every output equals the plain version."""
    a = _slot_case(chip_smoke.SLOTS_MATRIX["repeat_across_tiles"],
                   cuda_device)
    b = _slot_case(chip_smoke.SLOTS_LOOKBACK["lookback_E9"], cuda_device)
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(5):
        for s, (ids, E, _) in zip(streams, (a, b)):
            with torch.cuda.stream(s):
                outs.append(sl_ops.bucket_slots(ids, E))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        _assert_slots(got, (a, b)[i % 2][2], f"call {i}")
    for s in streams:
        assert (cuda_device, s.cuda_stream) in sl_ops._SCRATCH


@pytest.mark.cuda
def test_bucket_slots_renews_its_scratch_before_the_epochs_run_out(
        cuda_device, monkeypatch):
    """With a scratch good for 3 calls, the fourth call gets a zeroed one,
    and every call stays equal to the plain version."""
    monkeypatch.setattr(sl_ops, "_SCRATCH", {})
    monkeypatch.setattr(sl_ops, "MAX_CALLS", 3)
    ids, E, want = _slot_case(chip_smoke.SLOTS_MATRIX["repeat_across_tiles"],
                              cuda_device)
    held = []
    for i in range(8):
        _assert_slots(sl_ops.bucket_slots(ids, E), want, f"call {i}")
        held.append(next(iter(sl_ops._SCRATCH.values()))[0])
    assert len({id(t) for t in held}) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_bucket_slots_takes_a_view_at_any_offset(cuda_device, offset):
    """A view that starts 1-3 ints past a 16-byte boundary, invalid ids
    included, bit for bit with the plain version, in one launch."""
    T, E = 5001, 16
    base = to_torch(np.random.default_rng(offset).integers(
        -1, E + 1, offset + T + 7).astype(np.int32)).to(cuda_device)
    view = base[offset: offset + T]
    assert view.data_ptr() % 16 == 4 * offset
    before = sl_ops.bucket_slots.launches
    got = sl_ops.bucket_slots(view, E)
    torch.cuda.synchronize()
    assert sl_ops.bucket_slots.launches == before + 1
    _assert_slots(got, sl_ops.bucket_slots_ref(view, E), f"offset {offset}")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 100_003])
@pytest.mark.parametrize("mode", ["count", "owner"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_hist_kernel_takes_a_view_at_any_offset(cuda_device, offset, mode,
                                                n):
    """A view that starts 1-3 ints past a 16-byte boundary: the kernel
    counts the unaligned head and the tail itself, bit for bit with the
    plain version, in one launch, and counts nothing around the view."""
    from repro_torch.kernels.wordcount_hash.ref import hist_plain
    vocab, mod = (50_000, 0) if mode == "count" else (8, 8)
    base = to_torch(np.random.default_rng(offset).integers(
        0, vocab, offset + n + 7).astype(np.int32)).to(cuda_device)
    view = base[offset: offset + n]
    assert view.data_ptr() % 16 == 4 * offset
    before = wc_ops.wordcount_hist.launches
    got = wc_ops.wordcount_hist(view, vocab, mod)
    torch.cuda.synchronize()
    assert wc_ops.wordcount_hist.launches == before + 1
    assert_equal(got, hist_plain(view, vocab, hash_mod=mod).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["experts", "hd96", "group32", "fp16",
                                 "stride"])
def test_entry_point_kernels_reject_what_they_do_not_take(cuda_device, bad):
    if bad == "experts":
        ids = torch.zeros(64, dtype=torch.int32, device=cuda_device)
        with pytest.raises(ValueError, match="n_experts <="):
            sl_ops.bucket_slots(ids, sl_ops.MAX_EXPERTS + 1)
        return
    H, KV, hd, dtype = {"hd96": (4, 2, 96, torch.bfloat16),
                        "group32": (32, 1, 64, torch.bfloat16),
                        "fp16": (4, 2, 64, torch.float16),
                        "stride": (4, 2, 64, torch.bfloat16)}[bad]
    q = torch.zeros(1, H, hd, device=cuda_device, dtype=dtype)
    k = torch.zeros(1, 64, KV, hd, device=cuda_device, dtype=dtype)
    if bad == "stride":        # rows that start off a 16-byte boundary
        k = torch.zeros(1, 64, KV, hd + 1, device=cuda_device,
                        dtype=dtype)[..., 1:]
    with pytest.raises((TypeError, ValueError)):
        fd_ops.flash_decode(q, k, k, 10)


def _mutant_launches():
    from repro_torch.analysis.mutant_kernels import ops as m_ops
    return {k: getattr(m_ops, k).launches
            for k in chip_smoke.MUTANT_KERNELS.values()}


@pytest.mark.cuda
def test_mutant_kernels_match_plain_on_the_card(cuda_device):
    """Each near twin's kernel (copy_rows, table_add, copy_rows_i32) bit
    for bit against its plain version on seeded inputs, one launch each."""
    cases = {n: chip_smoke.mutant_call(n, cuda_device)
             for n in chip_smoke.MUTANT_KERNELS}
    before = _mutant_launches()
    errs = chip_smoke.check_cases(cases)
    torch.cuda.synchronize()
    assert errs == {n: 0 for n in cases}
    assert _mutant_launches() == {k: n + 1 for k, n in before.items()}


@pytest.mark.cuda
def test_lint_on_the_card(cuda_device, capsys):
    """The CLI with its default device (the card): the shipping kernels
    clean without a launch, the selftest PASS with each near twin's kernel
    launched once and no bad twin's."""
    from repro_torch.analysis import lint
    before = _mutant_launches()
    assert lint.main(["--kernels"]) == 0
    assert _mutant_launches() == before
    assert lint.main(["--selftest"]) == 0
    torch.cuda.synchronize()
    assert "PASS" in capsys.readouterr().out
    assert _mutant_launches() == {k: n + 1 for k, n in before.items()}


@pytest.mark.cuda
def test_program_lint_on_the_card(cuda_device, capsys):
    """``--programs`` on the card: the 82 shipping programs clean, the
    ``+fused`` ones capturing their step graphs under the lint's watch
    and launching fused_map once a step, as their handles count."""
    from repro_torch.analysis import corpus, lint
    steps = sum(h.steps for h in corpus.shipping_programs(cuda_device)
                if "+fused" in h.name)
    before = ops.fused_map.launches
    assert lint.main(["--programs"]) == 0
    torch.cuda.synchronize()
    assert "82 programs checked — clean" in capsys.readouterr().out
    assert ops.fused_map.launches - before == steps == 72


@pytest.mark.cuda
def test_mutant_wrappers_never_take_plain_on_the_card(cuda_device,
                                                      monkeypatch):
    from repro_torch.analysis.mutant_kernels import ops as m_ops

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(m_ops, "copy_rows_plain", plain)
    monkeypatch.setattr(m_ops, "table_add_plain", plain)
    for name in chip_smoke.MUTANT_KERNELS:
        out = chip_smoke.mutant_call(name, cuda_device)["run"]()
        assert out.is_cuda
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the coded shuffle and cross-job co-scheduling on the card
# ---------------------------------------------------------------------------

def _coded_cfg(r, stealing=False, segment=0):
    return JobConfig(WordCount(vocab=600), backend="1s", task_size=512,
                     push_cap=512, n_procs=6, code_rate=r,
                     stealing=stealing, segment=segment)


def _coded_input():
    from repro_torch.data.corpus import synth_corpus, zipf_skew_repeats
    return (synth_corpus(24576, 600, seed=0),
            zipf_skew_repeats(6, 8, 1.4, mean_rep=3, seed=1))


@pytest.mark.cuda
@pytest.mark.parametrize("r,stealing,segment", [(2, False, 0), (3, False, 3),
                                                (2, True, 0), (3, True, 2)])
def test_coded_job_on_the_card_equals_its_cpu_run(cuda_device, r, stealing,
                                                  segment):
    """An r 2 / r 3 coded job, with and without stealing, on the card:
    records, work and steals equal to the same job on the CPU, no
    fused_map launch, the engine's passes equal."""
    tokens, reps = _coded_input()
    cfg = _coded_cfg(r, stealing, segment)
    ops.fused_map.launches = 0
    h = submit(cfg, tokens, device=cuda_device, repeats=reps)
    got = h.result()
    assert ops.fused_map.launches == 0
    cpu = submit(cfg, tokens, device="cpu", repeats=reps)
    want = cpu.result()
    assert got.records == want.records == wordcount_oracle(tokens, 600)
    assert_equal(got.work_per_rank, want.work_per_rank)
    assert_equal(got.steals_per_rank, want.steals_per_rank)
    assert h.engine.steal.passes == cpu.engine.steal.passes
    if stealing:
        assert got.n_steals > 0


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3])
def test_coded_exchange_on_the_card_equals_the_cpu(cuda_device, r):
    from repro_torch.distributed.collectives import coded_exchange
    rng = np.random.default_rng(r)
    bk = rng.integers(-2**31, 2**31 - 1, (6, 6, 1024), dtype=np.int64)
    bk = np.where(rng.random(bk.shape) < 0.3, 2**31 - 1, bk).astype(np.int32)
    bv = rng.integers(-9, 9, (6, 6, 1024)).astype(np.int32)
    want = coded_exchange(to_torch(bk), to_torch(bv), r)
    got = coded_exchange(to_torch(bk).to(cuda_device),
                         to_torch(bv).to(cuda_device), r)
    for g, w in zip(got, want):
        assert g.is_cuda
        assert_equal(g, w)


@pytest.mark.cuda
def test_two_member_domain_on_the_card_equals_its_cpu_run(cuda_device):
    """Two stealing WordCount jobs co-scheduled at P 4 on the card: each
    member's records equal to its solo run, the domain's carry rows equal
    to the same domain's on the CPU, no fused_map launch."""
    from repro_torch.core import JobScheduler
    rng = np.random.default_rng(0)
    data = [rng.integers(0, 512, size=n * 64).astype(np.int32)
            for n in (13, 7)]
    reps = [np.where(rng.random((4, -(-n // 4))) < 0.3, 5, 1)
            .astype(np.int32) for n in (13, 7)]
    cfg = JobConfig(WordCount(vocab=512), backend="1s", task_size=64,
                    push_cap=128, n_procs=4, segment=1, stealing=True)
    rows = []
    for device in (cuda_device, "cpu"):
        sched = JobScheduler(device=device, coschedule=True, copack=2)
        for k, (d, r) in enumerate(zip(data, reps)):
            sched.submit(cfg, d, name=f"j{k}", repeats=r, priority=k)
        ops.fused_map.launches = 0
        res = sched.run_until_complete()
        assert ops.fused_map.launches == 0
        assert len(sched._domains) == 1
        carry = sched._domains[0].handle._carry
        rows.append(([res[f"j{k}"].records for k in range(2)],
                     [t.cpu().numpy().tolist() for t in
                      (carry.work, carry.stolen, carry.job_work)]))
    assert rows[0] == rows[1]
    for k, (d, r) in enumerate(zip(data, reps)):
        assert rows[0][0][k] == submit(cfg, d, device="cpu",
                                       repeats=r).result().records


# ---------------------------------------------------------------------------
# the elastic fleet on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n_old,n_new", [(8, 6), (8, 4), (6, 8)])
def test_fold_program_on_the_card_equals_the_host_twin(cuda_device, n_old,
                                                       n_new):
    """The fold program on cuda tensors: the folded windows equal the
    numpy twin ``fold_windows`` (near-INT32_MAX columns saturate), the
    owner rows fold, and the int32-wrapped checksum equals the twin's."""
    from repro_torch.fleet.remesh import _wrap_i32_sum, fold_program
    from repro_torch.ft.elastic import I32_MAX, fold_windows
    rng = np.random.default_rng(n_old * 10 + n_new)
    vocab = 4099
    tables = rng.integers(0, 1000, (n_old, vocab)).astype(np.int32)
    tables[:, :64] = rng.integers(I32_MAX // 3, I32_MAX, (n_old, 64))
    G = -(-n_old // n_new)
    groups = np.zeros((n_new, G, vocab), np.int32)
    for r in range(n_old):
        groups[r % n_new, r // n_new] = tables[r]
    row = (np.arange(vocab) % 13).astype(np.int32)
    rows = np.broadcast_to(row, (n_new, vocab)).copy()
    t, om, osp, cs = fold_program(n_old, n_new, vocab, cuda_device)(
        *(to_torch(a).to(cuda_device) for a in (groups, rows, rows)))
    assert t.is_cuda and cs.is_cuda
    want = fold_windows(tables, n_new)
    assert_equal(t, want)
    assert_equal(om, rows % n_new)
    assert_equal(osp, np.clip(rows, 1, n_new))
    assert_equal(cs, np.full((n_new,), _wrap_i32_sum(want), np.int32))


@pytest.mark.cuda
def test_fused_job_elastic_restored_8_to_6_replays_its_own_graphs(
        cuda_device, tmp_path):
    """A fused job snapshotted at P 8 and elastic-restored into a fresh
    fused handle at P 6 on the card: the restored handle captures its own
    graphs on its own carry, launches fused_map once a step (a graph
    replay each), and finishes with the uninterrupted job's records."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.fleet import elastic_restore
    data = np.random.default_rng(8).integers(0, 700, 30_000).astype(
        np.int32)
    reps = np.random.default_rng(9).integers(1, 4, (8, 30)).astype(np.int32)

    def cfg(P):
        return JobConfig(WordCount(vocab=700), task_size=128, push_cap=16,
                         n_procs=P, segment=5, fused_map=True)
    want = submit(cfg(8), data, device=cuda_device,
                  repeats=reps).result().records
    a = submit(cfg(8), data, device=cuda_device, repeats=reps)
    a.step(3)
    mgr = CheckpointManager(str(tmp_path))
    a.checkpoint(mgr).result(timeout=120)
    a.close()
    b = elastic_restore(submit(cfg(6), data, device=cuda_device), mgr)
    graphs = b.engine.graphs
    assert graphs is not None and graphs.carry is b.carry
    assert graphs.graphs == {}                    # captured anew below
    buffers = [t.data_ptr() for t in b.carry]
    ops.fused_map.launches = 0
    while b.step():
        pass
    torch.cuda.synchronize()
    steps = -(-b.feed.total_columns // 5) * 5     # segments of 5 columns
    assert graphs.replays == steps == ops.fused_map.launches > 0
    assert [t.data_ptr() for t in b.carry] == buffers
    assert b.result().records == want == wordcount_oracle(data, 700)


# ---------------------------------------------------------------------------
# LM training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_loader_copies_on_its_stream_while_the_step_runs(cuda_device):
    """With the current stream busy (a ~0.5 s spin standing in for the
    step), the next batch's copy, started by ``next``, completes on the
    loader's side stream; the consumer's stream waits for each batch,
    whose values are the host's."""
    import time

    from repro_torch.data.pipeline import DoubleBufferedLoader
    host = [{"tokens": np.full((64, 1 << 16), i, np.int32),
             "labels": np.full((64, 1 << 16), -i, np.int32)}
            for i in range(3)]
    loader = DoubleBufferedLoader(iter(host), cuda_device)
    assert loader._stream != torch.cuda.current_stream(cuda_device)
    torch.cuda.synchronize(cuda_device)
    torch.cuda._sleep(1_000_000_000)            # the step, ~0.5 s
    first = next(loader)                        # batch 1's copy starts
    copied = loader._next[1]
    t0 = time.perf_counter()
    while not copied.query():
        assert time.perf_counter() - t0 < 30, "the copy never completed"
        time.sleep(1e-3)
    assert not torch.cuda.current_stream(cuda_device).query(), \
        "the copy waited for the step"
    total = first["tokens"].sum() + first["labels"].sum()  # after the spin
    torch.cuda.synchronize(cuda_device)
    assert int(total) == 0
    for i, got in enumerate(loader, start=1):
        for k in got:
            assert got[k].is_cuda
            assert_equal(got[k], host[i][k], k)


@pytest.mark.cuda
def test_train_steps_on_the_card_equal_the_cpu_in_fp32(cuda_device):
    """Three fp32 steps of olmo-smoke at A = 2 on the card and on the CPU
    from the same weights: metrics within rtol 1e-4 (cuBLAS sums in
    another order), parameters within atol 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.models.transformer import init_model
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32",
                              param_dtype="float32")
    weights = params_to_numpy(cfg, init_model(cfg, 0, device="cpu"))
    batch = {k: np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                  (8, 64)).astype(np.int32)
             for k in ("tokens", "labels")}
    run, _, _ = chip_smoke.train_state(cfg, torch.device("cpu"), 64, 8, 4, 10)
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        state = init_train_state(cfg, run.train,
                                 params_from_numpy(cfg, weights, dev))
        step = make_train_step(cfg, run)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        ms = [{k: float(v) for k, v in step(state, b)[1].items()}
              for _ in range(3)]
        out[dev.type] = ms, params_to_numpy(cfg, state.params)
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for a, b in zip(out["cuda"][1]["blocks"]["layer0"]["mlp"].values(),
                    out["cpu"][1]["blocks"]["layer0"]["mlp"].values()):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.cuda
def test_train_phase_on_the_card_at_a_narrow_width(cuda_device):
    """Phase 5 at olmo-smoke (bf16) on the card: (a)-(d) hold, including
    A = 1 against A = 2 within 1e-2 / 2e-2 and the resume from the
    pinned async snapshot within 1e-3; no kernel launched; the profile
    saw device time."""
    from repro_torch.configs import get_smoke_config
    t = chip_smoke.phase_train(cuda_device, get_smoke_config("olmo-1b"),
                               seq=128, batch=8, microbatch=4, steps=8,
                               n_tokens=200_000)
    assert not any(t["launches"].values())
    assert t["grad_accum"] == 2 and len(t["grads_ms"]) == 8
    assert t["profile"]["device_s"] > 0 and t["peak_bytes"] > 0
    assert t["resume_max_rel_diff"] <= chip_smoke.TRAIN_RESUME_RTOL


# ---------------------------------------------------------------------------
# the MoE layer on the card: bucket_slots on the served path
# ---------------------------------------------------------------------------

def _moe_layer(cuda_device, **kw):
    """deepseek-v2-lite's SMOKE config (or ``kw`` over it) and one MoE
    layer of random weights on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import init_moe
    cfg = dataclasses.replace(get_smoke_config(chip_smoke.MOE_ARCH), **kw)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    return cfg, init_moe(cfg, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["1s", "2s"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_kernel_path_equals_the_plain_path(cuda_device, mode, dtype):
    """The MoE layer with its slots from the kernel equals the layer with
    them from ``bucket_slots_ref`` bit for bit on the card (the port
    combines by gathers, with no atomics), and in fp32 the CPU's run of
    the same weights within 1e-5."""
    from repro_torch.models.moe import moe_forward
    cfg, p = _moe_layer(cuda_device, dispatch_mode=mode, dtype=dtype,
                        param_dtype=dtype)
    x = torch.randn((4, 96, cfg.d_model), generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device) \
        .to(getattr(torch, dtype))
    with torch.inference_mode():
        yk, ak = moe_forward(cfg, p, x, use_kernel=True)
        yp, ap = moe_forward(cfg, p, x, use_kernel=False)
        assert torch.equal(yk, yp) and torch.equal(ak, ap)
        if dtype == "float32":
            yc, _ = moe_forward(cfg, {k: v.cpu() for k, v in p.items()},
                                x.cpu(), use_kernel=True)
            np.testing.assert_allclose(yk.cpu().numpy(), yc.numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_moe_forward_launches_twice_a_pipeline_step(cuda_device):
    """One 1s forward launches bucket_slots 2 (G + 1) times (G = 2 here),
    a 2s forward twice; the plain path launches it never."""
    from repro_torch.models.moe import moe_forward
    cfg, p = _moe_layer(cuda_device)
    x = torch.randn((2, 64, cfg.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    for mode, want in (("1s", 2 * (cfg.dispatch_groups + 1)), ("2s", 2)):
        before = sl_ops.bucket_slots.launches
        moe_forward(dataclasses.replace(cfg, dispatch_mode=mode), p, x,
                    use_kernel=True)
        torch.cuda.synchronize(cuda_device)
        assert sl_ops.bucket_slots.launches == before + want, mode
    before = sl_ops.bucket_slots.launches
    moe_forward(cfg, p, x, use_kernel=False)
    assert sl_ops.bucket_slots.launches == before


@pytest.mark.cuda
def test_bucket_slots_at_the_served_shapes(cuda_device, monkeypatch):
    """One MoE layer at deepseek-v2-lite's full width (d_model 2048, 64
    experts top-6, 2 shared) on a served batch of 8 x 2048 tokens:
    every slot call, the peer buckets (T 24,576 at E 1) and the expert
    buffers (T 30,721 at E 64) of each pipeline step, equals
    ``bucket_slots_ref`` bit for bit."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch.ref import bucket_slots_ref
    from repro_torch.models import moe
    cfg = get_config(chip_smoke.MOE_ARCH)
    p = moe.init_moe(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    x = torch.randn((8, 2048, cfg.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    real, shapes = sl_ops.bucket_slots, []

    def checked(ids, n, **kw):
        got = real(ids, n, **kw)
        want = bucket_slots_ref(ids, n)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        shapes.append((ids.numel(), n))
        return got

    monkeypatch.setattr(moe, "slot_ops", types.SimpleNamespace(
        bucket_slots=checked))
    with torch.inference_mode():
        moe.moe_forward(cfg, p, x, use_kernel=True)
    assert shapes == [(24_576, 1), (30_721, 64)] * 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_decode_step_kernel_path_equals_the_plain_path(cuda_device,
                                                           dtype):
    """One decode step of deepseek-v2-lite's SMOKE stack on the card: the
    engine's step launches bucket_slots 2 (G + 1) times an MoE layer,
    ``decode_step(use_kernel=False)`` never, and the two give the same
    logits and caches bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as eng
    cfg = dataclasses.replace(get_smoke_config(chip_smoke.MOE_ARCH),
                              dtype=dtype, param_dtype=dtype)
    model = tf.init_model(cfg, 0, device=cuda_device)
    B, S = 4, 48
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    with torch.inference_mode():
        _, _, raw = tf.forward(cfg, model, {"tokens": toks}, want_cache=True)
    engine = eng.ServeEngine(cfg, model, max_len=S + 4, device=cuda_device)
    nxt = toks[:, :1].to(torch.int32)
    moe_layers = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    out = {}
    for name, want in (("kernel", moe_layers * len(chip_smoke.slot_shapes(
            cfg, B))), ("plain", 0)):
        cache = eng.prefill_to_decode_cache(cfg, raw, S, S + 4)
        before = sl_ops.bucket_slots.launches
        with torch.inference_mode():
            out[name] = engine._step(model, cache, nxt, S) \
                if name == "kernel" else \
                tf.decode_step(cfg, model, cache, nxt, S, use_kernel=False)
        torch.cuda.synchronize(cuda_device)
        assert sl_ops.bucket_slots.launches == before + want, name
    assert torch.equal(out["kernel"][0], out["plain"][0])
    for a, b in zip(out["kernel"][1]["blocks"], out["plain"][1]["blocks"]):
        assert torch.equal(a["ckv"], b["ckv"])


# ---------------------------------------------------------------------------
# MoE training and the hybrid stack on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_moe_train_step_slots_through_the_kernel(cuda_device):
    """Phase 5 at deepseek-v2-lite's SMOKE config (bf16) on the card: the
    train step launches bucket_slots twice an MoE layer's slotting and
    microbatch (the forward and full remat's recompute) and nothing else;
    one step's slot calls, under full remat and under remat none, each
    equal ``bucket_slots_ref`` bit for bit, the recompute's the
    forward's, and the two steps' gradients agree."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(chip_smoke.MOE_ARCH)
    t = chip_smoke.phase_train(cuda_device, cfg, seq=128, batch=8,
                               microbatch=4, steps=6, resume_at=0,
                               n_tokens=200_000)
    moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    per_step = moe * 2 * (cfg.dispatch_groups + 1) * 2 * 2
    assert t["launches"]["bucket_slots"] == 6 * per_step
    assert not any(v for k, v in t["launches"].items()
                   if k != "bucket_slots")
    assert t["slots"]["calls_full"] == 2 * t["slots"]["calls_none"] > 0
    assert t["slots"]["remat_grad_rel"] <= chip_smoke.TRAIN_REMAT_RTOL


def _narrow_jamba(dtype="float32"):
    """jamba's SMOKE config widened to shapes the kernels take: head dim
    64 for flash_attention, SSD heads of 64 and chunk 64 for ssd_scan."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(
        get_smoke_config(chip_smoke.HYBRID_ARCH), d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=256, d_ff_expert=256, ssm_head_dim=64,
        ssm_chunk=64, dtype=dtype, param_dtype=dtype)


@pytest.mark.cuda
def test_hybrid_prefill_launches_its_three_kernels(cuda_device):
    """One prefill of a narrow jamba stack (one period: 7 SSD layers,
    attention at slot 4, MoE on the odd slots) launches flash_attention
    once, ssd_scan 7 times and bucket_slots 2 (G + 1) times an MoE
    layer; the plain path launches none, and the logits agree."""
    from repro_torch.models import transformer as tf
    cfg = _narrow_jamba()
    model = tf.init_model(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 192), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    kernels = chip_smoke.serve_kernels(cfg)
    assert sorted(kernels) == ["bucket_slots", "flash_attention", "ssd_scan"]
    out = {}
    for use_kernel in (True, False):
        before = {k: fn.launches for k, fn in kernels.items()}
        out[use_kernel] = tf.prefill(cfg, model, {"tokens": toks},
                                     use_kernel=use_kernel)
        torch.cuda.synchronize(cuda_device)
        got = {k: fn.launches - before[k] for k, fn in kernels.items()}
        want = {"flash_attention": 1, "ssd_scan": 7,
                "bucket_slots": 4 * 2 * (cfg.dispatch_groups + 1)}
        assert got == (want if use_kernel else dict.fromkeys(want, 0))
    np.testing.assert_allclose(out[True].cpu().numpy(),
                               out[False].cpu().numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.cuda
def test_hybrid_serve_phase_on_the_card_at_a_narrow_width(cuda_device):
    """Phase 4 on the narrow jamba stack in fp32: gates (a)-(e) hold."""
    s = chip_smoke.phase_serve(cuda_device, _narrow_jamba(), requests=3,
                               batch=2, prompt_len=192, new_tokens=4)
    assert s["launches"] == s["want_launches"]
    assert s["slots"]["calls"] > 0 and s["slots"]["decode_calls"] > 0
    assert s["layer_err_over_limit"] <= 1.0


HD160_CASES = [n for n, c in chip_smoke.FLASH_MATRIX.items() if c[4] == 160]


@pytest.mark.cuda
@pytest.mark.parametrize("name", HD160_CASES)
def test_flash_kernels_at_head_dim_160_match_plain(cuda_device, name):
    """stablelm-12b's head dim: the bf16 kernel (three panels, a 2-stage
    ring) and the fp32 kernel (two tail columns) launch once each case
    and hold to the plain version at its per-dtype tolerance."""
    before = fa_ops.flash_attention.launches
    errs = chip_smoke.phase_flash_vs_plain(
        cuda_device, {name: chip_smoke.FLASH_MATRIX[name]})
    assert fa_ops.flash_attention.launches == before + 1
    assert set(errs) == {name}


def _narrow_llama4(dtype="float32"):
    """llama4-maverick's SMOKE config cut to one dense and one MoE layer
    of 128 experts top-1 and the shared expert, at head dim 64 (which
    flash_attention takes)."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(
        get_smoke_config(chip_smoke.LLAMA4_ARCH), n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, d_head=64, d_ff=256, d_ff_expert=256,
        n_experts=128, dtype=dtype, param_dtype=dtype)


@pytest.mark.cuda
def test_llama4_prefill_slots_at_128_experts(cuda_device):
    """One prefill of the narrow llama4 stack: every bucket_slots call,
    at E 1 and at E 128, bit for bit bucket_slots_ref's on the same ids
    (``served_slots``), 2 (G + 1) launches for its MoE layer and one
    flash_attention launch a layer."""
    from repro_torch.models import transformer as tf
    cfg = _narrow_llama4()
    model = tf.init_model(cfg, 0, device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 160), device=cuda_device,
                         generator=torch.Generator(
                             device=cuda_device).manual_seed(1))
    kernels = chip_smoke.serve_kernels(cfg)
    before = {k: fn.launches for k, fn in kernels.items()}
    seen = chip_smoke.served_slots(lambda: tf.prefill(
        cfg, model, {"tokens": toks}, use_kernel=True))
    torch.cuda.synchronize(cuda_device)
    got = {k: fn.launches - before[k] for k, fn in kernels.items()}
    assert got == {"flash_attention": 2,
                   "bucket_slots": 2 * (cfg.dispatch_groups + 1)}
    assert seen["calls"] == got["bucket_slots"]
    assert set(seen["ids"]) == set(chip_smoke.slot_shapes(cfg, 2 * 160))
    assert any(n == 128 for _, n in seen["ids"])


@pytest.mark.cuda
def test_llama4_serve_phase_on_the_card_at_a_narrow_width(cuda_device):
    """Phase 4 on the narrow llama4 stack in fp32: gates (a)-(e) hold."""
    s = chip_smoke.phase_serve(cuda_device, _narrow_llama4(), requests=3,
                               batch=2, prompt_len=160, new_tokens=4)
    assert s["launches"] == s["want_launches"]
    assert s["slots"]["calls"] > 0 and s["slots"]["decode_calls"] > 0
    assert s["layer_err_over_limit"] <= 1.0


# ---------------------------------------------------------------------------
# the vision and audio frontends on the card
# ---------------------------------------------------------------------------

def _frontend_smoke(arch: str, dtype: str = "float32"):
    """internvl2's or whisper's SMOKE config at d_model 256, so that its
    4 heads are of head dim 64 (one flash_attention takes)."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), d_model=256,
                               d_head=64, dtype=dtype, param_dtype=dtype)


FRONTEND_ARCHS = (chip_smoke.VISION_ARCH, chip_smoke.AUDIO_ARCH)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_generate_on_the_card_matches_the_cpu(cuda_device, arch):
    """One ``generate`` with ``frontend_embeds`` (a 32-row prefix and 96
    text tokens; 64 frames and 128 text tokens, as ``frontend_geometry``
    splits 128) on the card, through flash_attention once an attention
    layer and prefill (whisper's encoder layers included), gives the
    CPU plain path's greedy tokens on the same fp32 weights."""
    import copy

    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine
    cfg = _frontend_smoke(arch)
    model = tf.init_model(cfg, 0, device="cpu")
    prompts, fe, ahead = chip_smoke.serve_inputs(cfg, 2, 128)
    max_len = ahead + 8 + 8
    want = engine.ServeEngine(cfg, model, max_len, device="cpu").generate(
        prompts, 8, frontend_embeds=fe)
    card = copy.deepcopy(model).to(cuda_device)
    before = fa_ops.flash_attention.launches
    got = engine.ServeEngine(cfg, card, max_len, device=cuda_device) \
        .generate(prompts, 8, frontend_embeds=fe)
    torch.cuda.synchronize(cuda_device)
    assert fa_ops.flash_attention.launches - before == \
        cfg.n_layers + cfg.n_enc_layers
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_whisper_bf16_prefill_runs_its_encoder_in_fp32(cuda_device):
    """A bf16 whisper stack on fp32 frames: the encoder's attention takes
    the fp32 kernel and the decoder's the bf16 one (one launch a layer
    each), ``cross_k``/``cross_v`` come out fp32 and the decoder's k/v
    and logits bf16, as JAX's promotion gives them; the logits within
    3e-2 * max|logits| of the plain path's on the card."""
    from repro_torch.models import transformer as tf
    cfg = _frontend_smoke(chip_smoke.AUDIO_ARCH, "bfloat16")
    model = tf.init_model(cfg, 0, device=cuda_device)
    prompts, fe, _ = chip_smoke.serve_inputs(cfg, 2, 128)
    batch = chip_smoke.serve_batch(prompts, fe, 0, 2, cuda_device)
    out = {}
    for use_kernel in (True, False):
        before = fa_ops.flash_attention.launches
        with torch.inference_mode():
            out[use_kernel] = tf.forward(cfg, model, batch, want_cache=True,
                                         use_kernel=use_kernel)
        torch.cuda.synchronize(cuda_device)
        assert fa_ops.flash_attention.launches - before == \
            (cfg.n_layers + cfg.n_enc_layers if use_kernel else 0)
    (lk, _, ck), (lr, _, _) = out[True], out[False]
    assert lk.dtype == torch.bfloat16
    for c in ck["blocks"]:
        assert c["k"].dtype == c["v"].dtype == torch.bfloat16
        assert c["cross_k"].dtype == c["cross_v"].dtype == torch.float32
        assert c["cross_k"].shape[1] == fe.shape[1]
    err = (lk.float() - lr.float()).abs().max().item()
    assert err <= 3e-2 * lr.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_serve_phase_on_the_card_at_a_narrow_width(cuda_device,
                                                            arch):
    """Phase 4 on the widened SMOKE stack in bf16 at a context of 256:
    its gates hold, and the launches are the code's count."""
    s = chip_smoke.phase_serve(cuda_device, _frontend_smoke(arch,
                                                            "bfloat16"),
                               requests=3, batch=2, prompt_len=256,
                               new_tokens=4)
    assert s["launches"] == s["want_launches"]
    assert s["layer_err_over_limit"] <= 1.0
    assert s["kernel_vs_ref_err_over_limit"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,buckets,launches", [(8, 32, 1), (8, 16, 1),
                                                    (8, 64, 2), (8, 128, 4),
                                                    (4, 256, 4)])
def test_cross_shard_slotting_launches(cuda_device, ranks, buckets,
                                       launches, monkeypatch):
    """A mesh's slotting step: one bucket_slots launch for all ranks'
    records while ranks x buckets fit the kernel's 256 (rank r's ids
    offset by r x buckets), one a group of ranks that fits past it; each
    rank's slots equal its own plain call's, invalid ids -1, and a CUDA
    tensor never reaches the plain version."""
    from repro_torch.models import moe
    rng = np.random.default_rng(ranks * buckets)
    ids = rng.integers(-1, buckets + 1, (ranks, 3001)).astype(np.int32)
    want = [sl_ops.bucket_slots_ref(torch.from_numpy(r), buckets)[0]
            for r in ids]

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(sl_ops, "bucket_slots_ref", plain)
    before = sl_ops.bucket_slots.launches
    got = moe._shard_slots(to_torch(ids).to(cuda_device), buckets,
                           use_kernel=True)
    torch.cuda.synchronize(cuda_device)
    assert sl_ops.bucket_slots.launches - before == launches == \
        moe.shard_slot_calls(ranks, buckets)
    for r in range(ranks):
        assert_equal(got[r].cpu().numpy(), want[r].numpy(), f"rank {r}")


@pytest.mark.cuda
def test_mesh_serve_phase_on_the_card_at_a_narrow_width(cuda_device):
    """Phase 4m on llama4-maverick's SMOKE stack in bf16 (GQA at head dim
    32 through flash_attention's 32-column instantiation, MoE layers of 8
    experts) under the (2, 4) mesh: its gates hold and the launches are
    the code's count."""
    from repro_torch.configs import get_smoke_config
    s = chip_smoke.phase_mesh_serve(
        cuda_device, get_smoke_config(chip_smoke.LLAMA4_ARCH), requests=4,
        prompt_len=64, new_tokens=3)
    assert s["launches"] == s["want_launches"]
    assert s["runs"]["unsharded"]["launches"] == \
        s["runs"]["unsharded"]["want_launches"]


@pytest.mark.cuda
def test_meta_tensors_take_the_plain_version_beside_the_card(cuda_device):
    """The kernel policy's meta rule: a ``meta`` tensor takes the plain
    version (no launch) and demanding the kernel on it raises, while a
    CUDA tensor still takes the kernel."""
    from repro_torch.kernels import backend
    meta = torch.empty(64, dtype=torch.int32, device="meta")
    assert backend.use_kernel(meta) is False
    with pytest.raises(ValueError, match="CUDA tensor"):
        backend.use_kernel(meta, require=True)
    before = sl_ops.bucket_slots.launches
    slots, _ = sl_ops.bucket_slots(meta, 8)
    assert slots.is_meta and sl_ops.bucket_slots.launches == before
    ids = torch.zeros(64, dtype=torch.int32, device=cuda_device)
    assert backend.use_kernel(ids) is True
    sl_ops.bucket_slots(ids, 8)
    torch.cuda.synchronize(cuda_device)
    assert sl_ops.bucket_slots.launches == before + 1


@pytest.mark.cuda
def test_every_smoke_config_serves_on_the_card(cuda_device):
    """Phase 4s: every arch of the registry at its SMOKE config,
    unmodified, through ``ServeEngine`` on the card: flash_attention at
    head dims 16, 20, 24 and 32, ssd_scan at P 16, N 16, chunk 16;
    launches equal to the code's count, the logits within 3e-2 *
    max|logits| of the plain path (jamba and internvl2 in fp32)."""
    from repro_torch.configs import ARCH_IDS
    s = chip_smoke.phase_smoke_serves(cuda_device)
    for arch in ARCH_IDS:
        assert s[arch]["launches"] == s[arch]["want_launches"], arch
        assert s[arch]["prefill_ms"] > 0 and s[arch]["decode_ms_per_token"] > 0
    assert s["mamba2-780m"]["launches"] == {"ssd_scan": 2}
    assert s["whisper-tiny"]["launches"] == {"flash_attention": 4}
