"""The port's MR-2S (``backend="2s"``) against the JAX package's.

The corpus generators equal JAX's bit for bit. ``submit(JobConfig(...,
backend="2s"))`` on ``device="cpu"`` equals the reference's ``"2s"`` at
P = 1 (in this process) and P = 8 (one 8-device subprocess for the
module), for every use-case, oneshot and segmented, under the balanced,
unbalanced and Zipf-skew repeat grids: records, JobResult stats and,
segmented, every EngineCarry field and the windows after the first
segment, tolerance 0. The blocking ``run_job`` equals the reference's;
2S's records equal 1S's; the map's block size does not change the
carry; ``fused_map=True`` raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.core.job as jjob  # noqa: E402
import repro.data.corpus as jcorpus  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.data.corpus as corpus  # noqa: E402
from repro_torch.core import twosided, windows  # noqa: E402
from repro_torch.core.kv import KEY_SENTINEL  # noqa: E402
from repro_torch.core.planner import gather_segment  # noqa: E402
from repro_torch.core.planner import plan_input, shard_task_ids  # noqa: E402
from repro_torch.data.feed import Segment  # noqa: E402
from repro_torch.data.source import ArraySource  # noqa: E402
from torch_parity import (STATS, USECASES, assert_equal,  # noqa: E402
                          assert_same_result, usecase)

VOCAB, N, TASK, CAP, SEG = 300, 8192, 64, 8, 4
MODES = {"oneshot": 0, "segmented": SEG}
GRIDS = ("balanced", "unbalanced", "zipf")


def _grid(name, P):
    """The three repeat grids of the 1S-against-2S comparison."""
    T = plan_input(N, TASK, P).tasks_per_proc
    if name == "zipf":
        return corpus.zipf_skew_repeats(P, T, 1.1, mean_rep=4, seed=1)
    return corpus.imbalance_repeats(P, T, mode=name, hot_factor=8,
                                    hot_fraction=0.125)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.zipf(1.4, N) % VOCAB).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_program_per_usecase():
    """The reference compiles a program for each ``map_fn`` object it is
    handed; one ``map_fn`` a use-case lets the grids share it."""
    orig, cache = jjob.as_map_fn, {}
    jjob.as_map_fn = lambda uc: cache.setdefault(uc, orig(uc))
    yield
    jjob.as_map_fn = orig


# ---------------------------------------------------------------------------
# the generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,vocab,a,seed", [
    (1000, 300, 1.3, 0), (4097, 262_144, 1.3, 3), (5000, 64, 1.1, 7),
    (257, 17, 2.0, 11)])
def test_zipf_tokens_and_synth_corpus_equal_jax(n, vocab, a, seed):
    assert_equal(corpus.zipf_tokens(n, vocab, a, seed),
                 jcorpus.zipf_tokens(n, vocab, a, seed))
    got = corpus.synth_corpus(n, vocab, seed)
    assert got.dtype == np.int32
    assert_equal(got, jcorpus.synth_corpus(n, vocab, seed))


@pytest.mark.parametrize("P,T,s,mean_rep,seed", [
    (8, 16, 1.1, 4, 1), (8, 65_536, 1.1, 4, 1), (4, 33, 0.0, 4, 0),
    (8, 7, 1.6, 2, 5), (1, 5, 0.6, 3, 2)])
def test_zipf_skew_repeats_equal_jax(P, T, s, mean_rep, seed):
    got = corpus.zipf_skew_repeats(P, T, s, mean_rep=mean_rep, seed=seed)
    assert got.dtype == np.int32 and got.min() >= 1
    assert_equal(got, jcorpus.zipf_skew_repeats(P, T, s, mean_rep=mean_rep,
                                                seed=seed))


# ---------------------------------------------------------------------------
# parity with JAX's "2s"
# ---------------------------------------------------------------------------

def _config(pkg, name, P, mode, backend="2s"):
    return pkg.JobConfig(usecase(pkg, name), backend=backend,
                         task_size=TASK, push_cap=CAP, n_procs=P,
                         segment=MODES[mode])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(USECASES))
def test_p1_equals_jax(data, name, mode, grid):
    reps = _grid(grid, 1)
    jh = jcore.submit(_config(jcore, name, 1, mode), data, repeats=reps)
    th = core.submit(_config(core, name, 1, mode), data, device="cpu",
                     repeats=reps)
    if mode == "segmented":
        jh.step()
        th.step()
        assert_equal(th.windows(), jh.windows(), "windows")
        for f, leaf in zip(windows.EngineCarry._fields,
                           windows.carry_to_numpy(th.carry)):
            assert_equal(leaf, np.asarray(getattr(jh.carry, f)), f)
    assert_same_result(th.result(), jh.result())


@pytest.fixture(scope="module")
def jax_p8(devices8, data, tmp_path_factory):
    """One 8-device JAX subprocess: every use-case under ``"2s"``,
    oneshot and segmented, under each grid; the carry and windows after
    the first segment, then the JobResult."""
    d = tmp_path_factory.mktemp("p8_2s")
    np.savez(d / "in.npz", data=data,
             **{g: _grid(g, 8) for g in GRIDS})
    devices8(f"""
        import numpy as np
        import repro.core as core
        import repro.core.job as job
        from repro.core.windows import EngineCarry
        orig, cache = job.as_map_fn, {{}}
        job.as_map_fn = lambda uc: cache.setdefault(uc, orig(uc))
        inp = np.load({str(d / "in.npz")!r})
        usecases = {USECASES!r}
        res = {{}}
        for name in usecases:
            uc = eval(usecases[name], vars(core))
            for mode, seg in {MODES!r}.items():
                for grid in {GRIDS!r}:
                    tag = "_".join((name, mode, grid))
                    cfg = core.JobConfig(uc, backend="2s",
                                         task_size={TASK}, push_cap={CAP},
                                         n_procs=8, segment=seg)
                    h = core.submit(cfg, inp["data"], repeats=inp[grid])
                    if seg:
                        h.step()
                        res[tag + "_windows"] = h.windows()
                        for f in EngineCarry._fields:
                            res[tag + "_carry_" + f] = np.asarray(
                                getattr(h.carry, f))
                    r = h.result()
                    for f in {STATS!r}:
                        res[tag + "_" + f] = np.asarray(getattr(r, f))
                    res[tag + "_rec"] = np.array(sorted(r.records.items()))
        np.savez({str(d / "out.npz")!r}, **res)
        print("OK")
    """)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(USECASES))
def test_p8_equals_jax(jax_p8, data, name, mode, grid):
    tag = "_".join((name, mode, grid))
    h = core.submit(_config(core, name, 8, mode), data, device="cpu",
                    repeats=_grid(grid, 8))
    if mode == "segmented":
        h.step()
        assert_equal(h.windows(), jax_p8[tag + "_windows"], "windows")
        for f, leaf in zip(windows.EngineCarry._fields,
                           windows.carry_to_numpy(h.carry)):
            assert_equal(leaf, jax_p8[f"{tag}_carry_{f}"], f"carry.{f}")
    res = h.result()
    assert res.backend == "2s"
    assert_equal(np.array(sorted(res.records.items())), jax_p8[tag + "_rec"])
    for f in STATS:
        assert_equal(np.asarray(getattr(res, f)), jax_p8[f"{tag}_{f}"], f)


@pytest.mark.parametrize("grid", GRIDS)
def test_blocking_run_job_equals_reference_run_job(data, grid):
    from repro.core.registry import JobSpec as JSpec
    from repro.core.twosided import run_job as jrun_job
    from repro.core.usecase import as_map_fn as jas_map_fn
    from repro.distributed.mesh import local_mesh
    plan = plan_input(N, TASK, 1)
    ids = shard_task_ids(plan)
    tokens = gather_segment(ArraySource(data), plan, ids)
    reps = _grid(grid, 1)
    keys, vals = twosided.run_job(
        core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP, n_procs=1),
        core.as_map_fn(core.WordCount(VOCAB)), "cpu", tokens, ids, reps)
    jkeys, jvals = jrun_job(
        JSpec(vocab=VOCAB, task_size=TASK, push_cap=CAP, n_procs=1),
        jas_map_fn(jcore.WordCount(VOCAB)), local_mesh((1,), ("procs",)),
        tokens, ids, reps)
    assert_equal(keys, jkeys)
    assert_equal(vals, jvals)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("P", [1, 3, 8])
def test_2s_records_equal_1s_and_the_oracle(data, P, grid):
    reps = _grid(grid, P)
    out = {}
    for backend in ("1s", "2s"):
        cfg = core.JobConfig(core.WordCount(VOCAB), backend=backend,
                             task_size=TASK, push_cap=CAP, n_procs=P,
                             segment=SEG)
        out[backend] = core.submit(cfg, data, device="cpu",
                                   repeats=reps).result()
    assert out["2s"].records == out["1s"].records == \
        core.wordcount_oracle(data, VOCAB)
    assert_equal(out["2s"].work_per_rank, out["1s"].work_per_rank)


@pytest.mark.parametrize("block", [1, 3, 10**6], ids=["1", "3", "all"])
def test_map_block_size_does_not_change_the_carry(data, monkeypatch, block):
    """Every block size gives the reference block's carry bit for bit,
    the overflow and send buffers included (cap 2 forces overflow)."""
    spec = core.JobSpec(vocab=VOCAB, task_size=TASK, push_cap=2, n_procs=8)
    map_fn = core.as_map_fn(core.WordCount(VOCAB))
    plan = plan_input(N, TASK, 8)
    ids = shard_task_ids(plan)
    tokens = torch.from_numpy(gather_segment(ArraySource(data), plan, ids))
    reps = _grid("zipf", 8)
    args = (tokens, torch.from_numpy(ids), torch.from_numpy(reps),
            reps.max(axis=0))

    def run():
        init, seg, _ = twosided.make_segment_fns(spec, map_fn, "cpu")
        bufs = twosided._map_all(spec, map_fn, *args,
                                 *init()[-2:])
        return windows.carry_to_numpy(
            seg(init(), Segment(*args[:3], ids, reps))), bufs

    want, want_bufs = run()
    monkeypatch.setattr(twosided, "MAP_BLOCK", block)
    got, got_bufs = run()
    for f, a, b in zip(windows.EngineCarry._fields, got, want):
        assert_equal(a, b, f)
    for a, b in zip(got_bufs, want_bufs):
        assert_equal(a, b)
    assert int((want_bufs[2] != KEY_SENTINEL).sum()) > 0


def test_fused_map_with_2s_raises(data):
    cfg = core.JobConfig(core.WordCount(VOCAB), backend="2s",
                         task_size=TASK, push_cap=CAP, n_procs=1,
                         fused_map=True)
    with pytest.raises(ValueError, match="fused"):
        core.submit(cfg, data, device="cpu")
    assert core.get_backend("2s") is core.get_backend("2s")
    assert not hasattr(core.get_backend("2s"), "supports_fused_map")
