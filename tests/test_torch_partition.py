"""The port's skew-aware partitioners against the JAX package's.

On the same seeded numpy inputs: ``SampledPartitioner.build`` (split on
and off, ``max_split`` and ``split_threshold`` varied, P in {1, 2, 8}),
``resolve_partitioner``, ``fold_owner_map``, ``owner_loads``,
``sample_key_histogram`` through the feed of each source kind and
``lookup_owner`` on split keys equal the reference's, tolerance 0. Jobs
with ``partitioner="sampled"`` and ``"sampled+split"`` on both backends,
eager and fused (its plain version on the CPU), equal the reference's
unfused jobs at P = 1 (in this process) and P = 8 (one 8-device
subprocess): records, the carried maps, ``n_split_keys`` and
``sample_tasks_read``. A sampled snapshot crosses between the packages
both ways, and ``restore`` adopts the snapshot's map without a sample.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.partition as jpart  # noqa: E402
import repro.data.source as jsource  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.core.partition as part  # noqa: E402
import repro_torch.data.source as source  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.core.planner import plan_input as jplan_input  # noqa: E402
from repro.core.planner import read_tasks as jread_tasks  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import windows  # noqa: E402
from repro_torch.core.planner import plan_input, shard_task_ids  # noqa: E402
from repro_torch.data.feed import SegmentFeed  # noqa: E402
from torch_parity import USECASES, assert_equal, usecase  # noqa: E402

VOCAB, N, TASK, CAP, SEG = 300, 8192, 64, 8, 4
# a threshold low enough that the hottest keys split at P = 8
SPLIT = dict(sample_tasks=12, split=True, split_threshold=0.1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.zipf(1.4, N) % VOCAB).astype(np.int32)


def _hist(seed, vocab, a=1.3, n_keys=None):
    """A seeded Zipf-like histogram: task counts over ``n_keys`` keys."""
    rng = np.random.default_rng(seed)
    hist = np.zeros(vocab, np.int64)
    keys = rng.permutation(vocab)[:n_keys or vocab]
    hist[keys] = (1000 / (1 + np.arange(len(keys))) ** a).astype(np.int64)
    return hist


# ---------------------------------------------------------------------------
# the maps, on the host
# ---------------------------------------------------------------------------

BUILDS = {
    "sampled": {},
    "split": dict(split=True),
    "split_t0.1": dict(split=True, split_threshold=0.1),
    "split_t0.02_max3": dict(split=True, split_threshold=0.02, max_split=3),
    "split_max12": dict(split=True, split_threshold=0.05, max_split=12),
    "t0.1_nosplit": dict(split_threshold=0.1),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("P", [1, 2, 8])
@pytest.mark.parametrize("kw", list(BUILDS))
def test_sampled_build_equals_jax(kw, P, seed):
    hist = _hist(seed, 500, n_keys=200 + 100 * seed)
    omap, osplit = part.SampledPartitioner(**BUILDS[kw]).build(hist, P)
    jmap, jsplit = jpart.SampledPartitioner(**BUILDS[kw]).build(hist, P)
    assert omap.dtype == np.asarray(jmap).dtype
    assert osplit.dtype == np.asarray(jsplit).dtype
    assert_equal(omap, jmap)
    assert_equal(osplit, jsplit)
    if P == 8 and kw.startswith("split_t"):
        assert (osplit > 1).any()            # the case splits keys


@pytest.mark.parametrize("hist", ["zeros", "one_key", "ties"])
def test_sampled_build_edges_equal_jax(hist):
    """No observed key; one key heavier than every rank's share; equal
    loads everywhere (the stable sort's and argmin's tie rules)."""
    h = {"zeros": np.zeros(64), "one_key": np.eye(64)[5] * 900 + 1,
         "ties": np.ones(64) * 3}[hist]
    for kw in BUILDS.values():
        for P in (1, 3, 8):
            got = part.SampledPartitioner(**kw).build(h, P)
            want = jpart.SampledPartitioner(**kw).build(h, P)
            for a, b in zip(got, want):
                assert_equal(a, b)


def test_resolve_partitioner_names_instances_and_errors():
    assert part.available_partitioners() == jpart.available_partitioners() \
        == ["hash", "sampled", "sampled+split"]
    for name in part.available_partitioners():
        got, want = part.resolve_partitioner(name), \
            jpart.resolve_partitioner(name)
        assert got.name == want.name == name
        assert got.needs_sample == want.needs_sample
        assert getattr(got, "split", False) == getattr(want, "split", False)
    custom = part.SampledPartitioner(sample_tasks=4, split=True)
    assert part.resolve_partitioner(custom) is custom
    assert isinstance(custom, part.Partitioner)
    for mod in (part, jpart):
        with pytest.raises(ValueError, match="unknown partitioner.*nope"):
            mod.resolve_partitioner("nope")
        with pytest.raises(TypeError, match="not a Partitioner"):
            mod.resolve_partitioner(42)


@pytest.mark.parametrize("n_new", [1, 3, 5, 8])
def test_fold_owner_map_and_owner_loads_equal_jax(n_new):
    hist = _hist(3, 400, a=1.1)
    omap, osplit = part.SampledPartitioner(split=True, split_threshold=0.05,
                                           max_split=6).build(hist, 8)
    got = part.fold_owner_map(omap, osplit, n_new)
    want = jpart.fold_owner_map(omap, osplit, n_new)
    for a, b in zip(got, want):
        assert a.dtype == np.asarray(b).dtype
        assert_equal(a, b)
    for m, s, P in ((omap, osplit, 8), (*got, n_new)):
        assert_equal(part.owner_loads(hist, m, s, P),
                     jpart.owner_loads(hist, m, s, P))
    assert part.owner_loads(hist, *got, n_new).sum() == pytest.approx(
        hist.sum())


def _sources(pkg, data, tmp_path):
    path = tmp_path / "tokens.bin"
    data.tofile(path)
    return {"array": pkg.ArraySource(data),
            "mmap": pkg.MmapTokenSource(str(path)),
            "zipf": pkg.ZipfSource(n=N, vocab=VOCAB, a=1.2, seed=4)}


@pytest.mark.parametrize("n_sample", [1, 5, 16, 10**6])
@pytest.mark.parametrize("name", list(USECASES))
@pytest.mark.parametrize("kind", ["array", "mmap", "zipf"])
def test_sample_key_histogram_equals_jax(tmp_path, data, kind, name,
                                         n_sample):
    """Through the port's feed (the reads counted in its stats) and the
    reference's planner read, over each source kind, for each use-case."""
    src = _sources(source, data, tmp_path)[kind]
    jsrc = _sources(jsource, data, tmp_path)[kind]
    plan = plan_input(src.len_elements(), TASK, 4)
    feed = SegmentFeed(src, plan, shard_task_ids(plan),
                       np.ones((4, plan.tasks_per_proc), np.int32),
                       segment=SEG, device="cpu", prefetch=False)
    uc, juc = usecase(core, name), usecase(jcore, name)
    got = part.sample_key_histogram(feed.sample_tasks, plan, uc, n_sample,
                                    window=uc.window + 7)
    jplan = jplan_input(jsrc.len_elements(), TASK, 4)
    want = jpart.sample_key_histogram(
        lambda ids: jread_tasks(jsrc, jplan, ids), jplan, juc, n_sample,
        window=juc.window + 7)
    assert got.dtype == want.dtype and got.shape == (uc.window + 7,)
    assert_equal(got, want)
    assert feed.stats.sample_tasks_read == min(n_sample, plan.n_tasks)
    assert feed.stats.bytes_read == 4 * TASK * min(n_sample, plan.n_tasks)
    feed.close()


@pytest.mark.parametrize("P", [2, 5, 8])
def test_lookup_owner_spreads_split_keys_by_task_id_as_jax(P):
    """Each key's owner under a split map, for task ids 0..63 and -1: the
    same replica as the reference's, and a split key's replicas all
    used."""
    hist = _hist(7, 128, a=1.6)
    omap, osplit = part.SampledPartitioner(split=True, split_threshold=0.05,
                                           max_split=P).build(hist, P)
    assert (osplit > 1).any()
    rng = np.random.default_rng(P)
    keys = rng.integers(-3, 140, (65, 48)).astype(np.int32)
    keys[:, :4] = np.flatnonzero(osplit > 1)[:1]          # a split key
    keys[0, 4] = 2**31 - 1
    tids = np.arange(-1, 64, dtype=np.int32)
    got = part.lookup_owner(
        torch.from_numpy(np.broadcast_to(omap, (65, 128)).copy()),
        torch.from_numpy(np.broadcast_to(osplit, (65, 128)).copy()),
        torch.from_numpy(keys), torch.from_numpy(tids), P).numpy()
    for t in range(65):
        want = jpart.lookup_owner(jnp.asarray(omap), jnp.asarray(osplit),
                                  jnp.asarray(keys[t]), jnp.int32(tids[t]),
                                  P)
        assert_equal(got[t], want, f"task {tids[t]}")
    k = int(keys[0, 0])
    replicas = {(int(omap[k]) + j) % P for j in range(int(osplit[k]))}
    assert set(got[:, 0].tolist()) == replicas


# ---------------------------------------------------------------------------
# jobs against the reference's unfused jobs
# ---------------------------------------------------------------------------

PARTS = {"sampled": {}, "sampled+split": SPLIT}
MODES = {"oneshot": 0, "segmented": SEG}


def _partitioner(pkg, name):
    return pkg.SampledPartitioner(**PARTS[name])


def _config(pkg, name, P, backend, mode, fused=False):
    return pkg.JobConfig(pkg.WordCount(VOCAB), backend=backend,
                         task_size=TASK, push_cap=CAP, n_procs=P,
                         segment=MODES[mode], fused_map=fused,
                         partitioner=_partitioner(pkg, name))


def _carried_maps(h):
    return [np.asarray(h.carry.owner_map), np.asarray(h.carry.owner_split)]


def _check(h, res, want: dict, P, data):
    assert res.records == want["records"] == core.wordcount_oracle(
        data, VOCAB)
    assert res.partitioner == want["partitioner"]
    assert res.n_split_keys == want["n_split_keys"]
    assert h.feed.stats.sample_tasks_read == want["sample_tasks_read"]
    for got, w, f in zip(windows.carry_to_numpy(h.carry)[-2:],
                         want["maps"], ("owner_map", "owner_split")):
        assert got.shape == (P, VOCAB)
        assert_equal(got, w, f)


# 2S has no fused path (the reference's has none)
ENGINES = {"1s_eager": ("1s", False), "1s_fused": ("1s", True),
           "2s": ("2s", False)}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(PARTS))
def test_p1_sampled_jobs_equal_jax(data, name, mode, engine):
    backend, fused = ENGINES[engine]
    jh = jcore.submit(_config(jcore, name, 1, backend, mode), data)
    jres = jh.result()
    want = {"records": jres.records, "partitioner": jres.partitioner,
            "n_split_keys": jres.n_split_keys,
            "sample_tasks_read": jh.feed.stats.sample_tasks_read,
            "maps": _carried_maps(jh)}
    h = core.submit(_config(core, name, 1, backend, mode, fused), data,
                    device="cpu")
    _check(h, h.result(), want, 1, data)
    assert want["sample_tasks_read"] == (12 if name == "sampled+split"
                                         else 16)


@pytest.fixture(scope="module")
def jax_p8(devices8, data, tmp_path_factory):
    """One 8-device JAX subprocess: each sampled partitioner on each
    backend, oneshot and segmented; records, maps, stats."""
    d = tmp_path_factory.mktemp("p8_part")
    np.save(d / "data.npy", data)
    devices8(f"""
        import numpy as np
        import repro.core as core
        data = np.load({str(d / "data.npy")!r})
        res = {{}}
        for name, kw in {PARTS!r}.items():
            for backend in ("1s", "2s"):
                for mode, seg in {MODES!r}.items():
                    tag = "_".join((name, backend, mode))
                    cfg = core.JobConfig(
                        core.WordCount({VOCAB}), backend=backend,
                        task_size={TASK}, push_cap={CAP}, n_procs=8,
                        segment=seg,
                        partitioner=core.SampledPartitioner(**kw))
                    h = core.submit(cfg, data)
                    r = h.result()
                    res[tag + "_rec"] = np.array(sorted(r.records.items()))
                    res[tag + "_split"] = r.n_split_keys
                    res[tag + "_sampled"] = h.feed.stats.sample_tasks_read
                    res[tag + "_omap"] = np.asarray(h.carry.owner_map)
                    res[tag + "_osplit"] = np.asarray(h.carry.owner_split)
        np.savez({str(d / "out.npz")!r}, **res)
        print("OK")
    """)
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(PARTS))
def test_p8_sampled_jobs_equal_jax(jax_p8, data, name, mode, engine):
    backend, fused = ENGINES[engine]
    tag = "_".join((name, backend, mode))
    want = {"records": dict(jax_p8[tag + "_rec"].tolist()),
            "partitioner": name,
            "n_split_keys": int(jax_p8[tag + "_split"]),
            "sample_tasks_read": int(jax_p8[tag + "_sampled"]),
            "maps": [jax_p8[tag + "_omap"], jax_p8[tag + "_osplit"]]}
    h = core.submit(_config(core, name, 8, backend, mode, fused), data,
                    device="cpu")
    res = h.result()
    _check(h, res, want, 8, data)
    if name == "sampled+split":
        assert res.n_split_keys > 0           # split keys were routed
    if mode == "segmented":
        # the map routes the push: after a segment the windows hold other
        # keys than the hash rule's
        hashed = core.submit(core.JobConfig(
            core.WordCount(VOCAB), backend=backend, task_size=TASK,
            push_cap=CAP, n_procs=8, segment=SEG), data, device="cpu")
        h2 = core.submit(_config(core, name, 8, backend, mode, fused), data,
                         device="cpu")
        hashed.step()
        h2.step()
        assert not np.array_equal(h2.windows() != 0,
                                  hashed.windows() != 0)
        h2.close()
        hashed.close()


def test_the_sample_is_taken_once_and_counts_into_the_wall(data):
    # no prefetch: each step's read lands in bytes_read within the step
    h = core.submit(_config(core, "sampled", 8, "1s", "segmented"), data,
                    device="cpu", prefetch=False)
    h.step()
    read = h.feed.stats.bytes_read
    assert h.feed.stats.sample_tasks_read == 16 and h._wall > 0
    h.step()
    assert h.feed.stats.sample_tasks_read == 16
    assert h.feed.stats.bytes_read > read
    h.close()


def test_a_failed_pre_pass_is_taken_again_at_the_next_step(data,
                                                          monkeypatch):
    """A read error in the sample leaves the job unsampled, not on the
    hash seed: the next step samples again and installs the map a clean
    job installs."""
    cfg = _config(core, "sampled+split", 8, "1s", "segmented")
    clean = core.submit(cfg, data, device="cpu")
    clean.step()
    h = core.submit(cfg, data, device="cpu")
    read = h.feed.sample_tasks

    def broken(ids):
        raise OSError("the sample's read failed")

    monkeypatch.setattr(h.feed, "sample_tasks", broken)
    with pytest.raises(OSError, match="sample"):
        h.step()
    assert h.cursor == 0
    monkeypatch.setattr(h.feed, "sample_tasks", read)
    h.step()
    maps = _carried_maps(clean)
    assert not np.array_equal(maps[0][0], part.hash_owner_map(VOCAB, 8))
    for got, want in zip(_carried_maps(h), maps):
        assert_equal(got, want)
    assert h.result().records == clean.result().records


# ---------------------------------------------------------------------------
# snapshots of a sampled job
# ---------------------------------------------------------------------------

def test_sampled_restore_adopts_the_snapshots_map(tmp_path, data):
    """A snapshot taken before the first step already holds the sampled
    map; a restore adopts it with no sample, and a partitioner mismatch
    is refused."""
    cfg = _config(core, "sampled+split", 8, "1s", "segmented")
    a = core.submit(cfg, data, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    a.checkpoint(mgr)
    mgr.wait()
    maps = _carried_maps(a)
    want = a.result().records
    b = core.submit(cfg, data, device="cpu").restore(mgr)
    res = b.result()
    assert res.records == want and b.feed.stats.sample_tasks_read == 0
    for got, w in zip(_carried_maps(b), maps):
        assert_equal(got, w)
    with pytest.raises(ValueError, match="partitioner"):
        core.submit(_config(core, "sampled", 8, "1s", "segmented"), data,
                    device="cpu").restore(mgr)


@pytest.mark.parametrize("name", list(PARTS))
def test_sampled_snapshot_crosses_between_the_packages(tmp_path, data, name):
    """P = 1: the reference's snapshot after one segment restores into the
    port and finishes with its records, and the port's restores into the
    reference; both carry the same maps."""
    jh = jcore.submit(_config(jcore, name, 1, "1s", "segmented"), data)
    jh.step()
    jmgr = JManager(str(tmp_path / "jax"))
    jh.checkpoint(jmgr)
    jmgr.wait()
    want = jh.result().records
    th = core.submit(_config(core, name, 1, "1s", "segmented"), data,
                     device="cpu").restore(CheckpointManager(
                         str(tmp_path / "jax")))
    assert th.cursor == SEG and th.feed.stats.sample_tasks_read == 0
    assert th.result().records == want
    t2 = core.submit(_config(core, name, 1, "1s", "segmented"), data,
                     device="cpu")
    t2.step()
    tmgr = CheckpointManager(str(tmp_path / "port"))
    t2.checkpoint(tmgr)
    tmgr.wait()
    maps = _carried_maps(t2)
    t2.close()
    j2 = jcore.submit(_config(jcore, name, 1, "1s", "segmented"), data)
    j2.restore(JManager(str(tmp_path / "port")))
    for got, w in zip(_carried_maps(j2), maps):
        assert_equal(got, w)
    assert j2.result().records == want
