"""The port's elastic fleet against the JAX package.

``repro_torch.ft.elastic``, ``repro_torch.fleet`` (faults, remesh,
supervisor) and ``JobHandle.elastic_load`` on ``device="cpu"``. Every
input is a numpy seed and every value an integer, so every comparison is
bit for bit (tolerance 0): the host helpers (``fold_windows``,
``rebucketize_tasks``, ``remesh_fleet``/``remesh_plan``,
``FaultPlan.generate``) against ``repro.ft.elastic`` and
``repro.fleet.faults`` on the same inputs; the fold program against the
reference's ``fold_program`` at P 8 -> 6 and 8 -> 4, windows whose sums
wrap int32 included; P 8 snapshots taken by the reference and by the
port, restored at P 6 and P 4 by the port (and the port's by the
reference), against the reference's own restore and solo records; the
port's stealing and fused arms against their solo runs and the oracle
(the reference's stealing and fused jobs do not trace under the
installed jax); the supervisor at P 1 in this process beside the
reference's, and the reference's kill-to-P-6 fleet of four in one
8-device subprocess for the module.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.fleet as jfleet  # noqa: E402
import repro.fleet.remesh as jremesh  # noqa: E402
import repro.ft.elastic as jel  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.fleet as fleet  # noqa: E402
import repro_torch.fleet.remesh as remesh  # noqa: E402
import repro_torch.ft.elastic as el  # noqa: E402
from repro.ckpt import CheckpointManager as JManager  # noqa: E402
from repro.data.source import ArraySource as JArraySource  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core.combine import sat_add_i32  # noqa: E402
from repro_torch.core.kv import KEY_SENTINEL  # noqa: E402
from repro_torch.data.source import ArraySource  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

I32_MAX = el.I32_MAX

# the reference's matrix (tests/test_fleet.py): 4,096 tokens over 96 keys
MVOCAB, MN, MTASK, MCAP = 96, 4096, 16, 128
MUSECASES = {"wc": "WordCount(vocab=96)",
             "hist": "Histogram(vocab=96, n_bins=16)",
             "inv": "InvertedIndex(queries=(3, 5, 7), n_docs=8, "
                    "tasks_per_doc=4)"}
PARTS = ("hash", "sampled+split")
P_NEWS = (6, 4)
SNAP_STEP = 5

# the reference's kill-to-P-6 fleet (tests/test_fleet.py:360)
FVOCAB = 128


def _uc(pkg, name):
    return eval(MUSECASES[name], {k: getattr(pkg, k) for k in
                                  ("WordCount", "Histogram",
                                   "InvertedIndex")})


def _mcfg(pkg, name, P, **kw):
    return pkg.JobConfig(usecase=_uc(pkg, name), backend="1s",
                         task_size=MTASK, push_cap=MCAP, segment=2,
                         n_procs=P, **kw)


@pytest.fixture(scope="module")
def mtokens():
    rng = np.random.default_rng(5)
    return rng.integers(0, MVOCAB, size=MN).astype(np.int32)


def _fleet_data():
    rng = np.random.default_rng(1)
    return {f"j{i}": rng.integers(0, FVOCAB, size=4096 + 1024 * i)
            .astype(np.int32) for i in range(4)}


def _fleet_cases(pkg):
    return {"j0": pkg.WordCount(vocab=FVOCAB),
            "j1": pkg.WordCount(vocab=FVOCAB),
            "j2": pkg.Histogram(vocab=FVOCAB, n_bins=32),
            "j3": pkg.WordCount(vocab=FVOCAB)}


def _fcfg(pkg, uc, P=8):
    return pkg.JobConfig(usecase=uc, backend="1s", task_size=16,
                         push_cap=128, segment=2, n_procs=P)


def _fold_windows_cases():
    """Seeded (P_old, vocab) windows: random counts, near-INT32_MAX
    columns whose folds saturate, sums past 2**31 (the checksum wraps)."""
    rng = np.random.default_rng(11)
    out = {}
    for name, P_old, P_new, vocab in (("8to6", 8, 6, 40),
                                      ("8to4", 8, 4, 40),
                                      ("8to6_wrap", 8, 6, 40)):
        t = rng.integers(0, 1000, size=(P_old, vocab)).astype(np.int32)
        if name == "8to6_wrap":
            t[:, :8] = rng.integers(I32_MAX // 3, I32_MAX,
                                    size=(P_old, 8)).astype(np.int32)
        out[name] = (t, P_new)
    return out


def _port_snapshots(tokens, root):
    """The port's P 8 snapshots at step 5, one a use-case and partitioner
    (stealing off), for the reference to restore too."""
    dirs = {}
    for name in MUSECASES:
        for part in PARTS:
            d = root / f"port-{name}-{part}"
            mgr = CheckpointManager(str(d))
            h = core.submit(_mcfg(core, name, 8, partitioner=part), tokens,
                            device="cpu")
            h.step(SNAP_STEP)
            h.checkpoint(mgr).result()
            h.close()
            dirs[f"{name}|{part}"] = str(d)
    return dirs


@pytest.fixture(scope="module")
def ref(devices8, mtokens, tmp_path_factory):
    """One 8-device JAX subprocess for the module: (1) the reference's
    fold program on the seeded windows; (2) for each use-case and
    partitioner, its solo records, its own P 8 snapshot at step 5 and its
    elastic restores of that snapshot at P 6 and P 4, and its restores of
    the port's snapshot; (3) its kill-to-P-6 fleet of four."""
    d = tmp_path_factory.mktemp("elastic")
    port_dirs = _port_snapshots(mtokens, d)
    folds = _fold_windows_cases()
    np.savez(d / "in.npz", tokens=mtokens,
             **{f"t_{k}": t for k, (t, _) in folds.items()})
    meta = {"port_dirs": port_dirs,
            "p_new": {k: p for k, (_, p) in folds.items()}}
    (d / "meta.json").write_text(json.dumps(meta))
    devices8(f"""
        import json
        import numpy as np
        import repro.core as core
        from repro.ckpt import CheckpointManager
        from repro.distributed.mesh import make_mesh
        from repro.fleet import (FaultEvent, FaultPlan, FleetSupervisor,
                                 elastic_restore, fold_program)
        from repro.fleet.remesh import _wrap_i32_sum
        from repro.ft.elastic import fold_windows, remesh_fleet

        root = {str(d)!r}
        inp = np.load(root + "/in.npz")
        meta = json.load(open(root + "/meta.json"))
        tokens = inp["tokens"]
        out, rec = {{}}, {{}}

        for name, P_new in meta["p_new"].items():
            t = inp["t_" + name]
            P_old, vocab = t.shape
            G = -(-P_old // P_new)
            groups = np.zeros((P_new, G, vocab), np.int32)
            for r in range(P_old):
                groups[r % P_new, r // P_new] = t[r]
            om = np.broadcast_to(
                (np.arange(vocab) * 7 % 11).astype(np.int32),
                (P_new, vocab)).copy()
            osp = np.broadcast_to(
                (np.arange(vocab) % 9).astype(np.int32),
                (P_new, vocab)).copy()
            fn = fold_program(make_mesh(remesh_fleet(P_new)), P_old, vocab)
            tab, om2, os2, cs = fn(groups, om, osp)
            out[name + "_groups"] = groups
            out[name + "_om"] = om
            out[name + "_os"] = osp
            out[name + "_table"] = np.asarray(tab)
            out[name + "_om_new"] = np.asarray(om2)
            out[name + "_os_new"] = np.asarray(os2)
            out[name + "_csum"] = np.asarray(cs)
            out[name + "_twin"] = np.int64(
                _wrap_i32_sum(fold_windows(t, P_new)))

        usecases = {MUSECASES!r}
        for name, expr in usecases.items():
            uc = eval(expr, vars(core))
            for part in {PARTS!r}:
                def cfg(P):
                    return core.JobConfig(
                        usecase=uc, backend="1s", task_size={MTASK},
                        push_cap={MCAP}, segment=2, n_procs=P,
                        partitioner=part)
                key = name + "|" + part
                rec[key + "|solo"] = sorted(
                    core.submit(cfg(8), tokens).result().records.items())
                mgr = CheckpointManager(root + "/ref-" + name + "-" + part)
                h = core.submit(cfg(8), tokens)
                h.step({SNAP_STEP})
                h.checkpoint(mgr).result()
                h.close()
                port_mgr = CheckpointManager(meta["port_dirs"][key])
                for P_new in {P_NEWS!r}:
                    for who, m in (("ref", mgr), ("port", port_mgr)):
                        r = elastic_restore(core.submit(cfg(P_new), tokens),
                                            m).result()
                        rec[key + "|" + who + "|" + str(P_new)] = sorted(
                            r.records.items())

        rng = np.random.default_rng(1)
        data = {{f"j{{i}}": rng.integers(0, {FVOCAB}, size=4096 + 1024 * i)
                .astype(np.int32) for i in range(4)}}
        cases = {{"j0": core.WordCount(vocab={FVOCAB}),
                  "j1": core.WordCount(vocab={FVOCAB}),
                  "j2": core.Histogram(vocab={FVOCAB}, n_bins=32),
                  "j3": core.WordCount(vocab={FVOCAB})}}
        def fcfg(uc):
            return core.JobConfig(usecase=uc, backend="1s", task_size=16,
                                  push_cap=128, segment=2, n_procs=8)
        plan = FaultPlan((FaultEvent(3, "kill", ranks=(1, 5)),))
        sup = FleetSupervisor(n_procs=8, ckpt_dir=root + "/fleet",
                              plan=plan, ckpt_every=1, slices_per_tick=4)
        for n in data:
            sup.submit(fcfg(cases[n]), data[n], name=n)
        res = sup.run(max_ticks=500)
        sup.close()
        for n in data:
            rec["fleet|" + n] = sorted(res[n].records.items())
        rec["fleet|stats"] = {{
            "failed": sorted(sup.failed), "n_procs": sup.n_procs,
            "recoveries": [[r.kind, r.p_old, r.p_new, r.jobs_restored,
                            r.jobs_scratch] for r in sup.recoveries],
            "faults_fired": [e.source.faults_fired
                             for e in sup.entries.values()],
            "kinds": [t["kind"] for t in sup.timeline]}}
        np.savez(root + "/out.npz", **out)
        json.dump(rec, open(root + "/rec.json", "w"))
        print("OK")
    """)
    rec = json.loads((d / "rec.json").read_text())
    return {"fold": dict(np.load(d / "out.npz")), "rec": rec, "dir": d,
            "port_dirs": port_dirs}


def _records(pairs):
    return {int(k): int(v) for k, v in pairs}


# ---------------------------------------------------------------------------
# host helpers against the reference
# ---------------------------------------------------------------------------

def _windows(case):
    rng = np.random.default_rng(3)
    if case == "saturates":
        return np.array([[I32_MAX - 5, 10], [7, 20]], np.int32), 1
    if case == "random_int32":
        return rng.integers(0, I32_MAX, size=(8, 16)).astype(np.int32), 3
    if case == "grow":
        return rng.integers(0, 50, size=(3, 9)).astype(np.int32), 5
    if case == "uint16":
        return rng.integers(0, 60_000, size=(6, 5)).astype(np.uint16), 4
    if case == "int64_wide":
        return np.full((4, 3), np.int64(I32_MAX) * 4, np.int64), 2
    if case == "float32":
        return rng.standard_normal((7, 6)).astype(np.float32), 3
    raise ValueError(case)


@pytest.mark.parametrize("case", ["saturates", "random_int32", "grow",
                                  "uint16", "int64_wide", "float32"])
def test_fold_windows_equals_reference(case):
    tables, n_new = _windows(case)
    got = el.fold_windows(tables, n_new)
    want = jel.fold_windows(tables, n_new)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert_equal(got, want)
    if case == "saturates":
        assert got[0, 0] == I32_MAX and got[0, 1] == 30
    if case == "int64_wide":               # wide windows are not clipped
        assert_equal(got.sum(axis=0), tables.sum(axis=0))


def test_fold_windows_saturation_matches_the_device_sat_add():
    """int64-accumulate-then-clip == the engine's pairwise
    ``sat_add_i32`` over a random fold near INT32_MAX."""
    rng = np.random.default_rng(0)
    tables = rng.integers(0, I32_MAX, size=(8, 16)).astype(np.int32)
    folded = el.fold_windows(tables, 3)
    for d in range(3):
        acc = torch.zeros(16, dtype=torch.int32)
        for r in range(d, 8, 3):
            acc = sat_add_i32(acc, torch.from_numpy(tables[r]))
        assert_equal(folded[d], acc)


def _grids(case):
    rng = np.random.default_rng(9)
    if case == "holes":
        ids = np.array([[0, 2, 4, -1], [1, 3, 5, 6]], np.int32)
        reps = np.array([[1, 2, 3, 1], [4, 5, 6, 7]], np.int32)
        return ids, reps, 1, 3
    if case == "exhausted":
        ids = np.array([[0, 1], [2, 3]], np.int32)
        return ids, np.ones_like(ids), 2, 4
    if case == "holes_inside_rows":
        ids = rng.permutation(8 * 12).astype(np.int32).reshape(8, 12)
        ids[rng.random(ids.shape) < 0.2] = -1
        return ids, rng.integers(1, 9, ids.shape).astype(np.int32), 5, 6
    if case == "grow":
        ids = np.arange(6 * 7, dtype=np.int32).reshape(7, 6).T.copy()
        return ids, rng.integers(1, 4, ids.shape).astype(np.int32), 2, 8
    if case == "cursor_zero":
        ids = np.arange(30, dtype=np.int32).reshape(5, 6)
        return ids, rng.integers(1, 4, ids.shape).astype(np.int32), 0, 4
    raise ValueError(case)


@pytest.mark.parametrize("case", ["holes", "exhausted", "holes_inside_rows",
                                  "grow", "cursor_zero"])
def test_rebucketize_tasks_equals_reference(case):
    ids, reps, cursor, n_new = _grids(case)
    got = el.rebucketize_tasks(ids, reps, cursor, n_new)
    want = jel.rebucketize_tasks(ids, reps, cursor, n_new)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert_equal(g, w)
    grid, greps = got
    left = ids[:, cursor:]
    assert sorted(grid[grid >= 0].tolist()) == sorted(left[left >= 0]
                                                      .tolist())
    # -1 only at the tail of the dealt order
    flat = grid.T.ravel()
    n = int((flat >= 0).sum())
    assert (flat[:n] >= 0).all() and (flat[n:] == -1).all()
    if case == "holes":
        assert {int(t): int(r) for t, r in zip(grid.ravel(), greps.ravel())
                if t >= 0} == {2: 2, 4: 3, 3: 5, 5: 6, 6: 7}
    if case == "exhausted":
        assert grid.shape == greps.shape == (4, 0)


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 24, 31, 64, 256])
def test_remesh_fleet_and_plan_equal_reference(n):
    for got, want in ((el.remesh_fleet(n), jel.remesh_fleet(n)),
                      (el.remesh_plan(n), jel.remesh_plan(n)),
                      (el.remesh_plan(n, prefer_model=4),
                       jel.remesh_plan(n, prefer_model=4))):
        assert (got.shape, got.axes) == (want.shape, want.axes)
        for prop in ("n_devices", "dp_axes", "dp_size", "tp_size"):
            assert getattr(got, prop) == getattr(want, prop), prop
    assert el.remesh_fleet(n).axes == ("procs",)


def _outcome(fn, n):
    try:
        cfg = fn(n)
    except ValueError as e:
        return "ValueError: " + str(e)
    return (cfg.shape, cfg.axes)


@pytest.mark.parametrize("fn", ["remesh_fleet", "remesh_plan"])
@pytest.mark.parametrize("n", [0, -2])
def test_remesh_validation_equals_reference(fn, n):
    """Both refuse 0 ranks; below that the reference's ``remesh_plan``
    returns a shape, and so does the port's."""
    got = _outcome(getattr(el, fn), n)
    assert got == _outcome(getattr(jel, fn), n)
    if n == 0 or fn == "remesh_fleet":
        assert got.startswith("ValueError: no mesh")


def test_surviving_ranks_equals_reference():
    for P, failed in ((8, [1, 5]), (6, []), (4, [0, 1, 2, 3]), (3, [7])):
        assert el.surviving_ranks(P, failed) == jel.surviving_ranks(P,
                                                                    failed)


def test_fold_job_windows_equals_reference(tokens1):
    """A mid-job handle's windows (pending chunk included) folded onto 3
    ranks, the port's and the reference's, after the same two segments
    at P 1."""
    h = core.submit(wc_cfg(), tokens1, device="cpu")
    j = jcore.submit(wc_cfg(jcore), tokens1)
    h.step(2)
    j.step(2)
    got = el.fold_job_windows(h, 3)
    assert_equal(got, jel.fold_job_windows(j, 3))
    assert got.shape == (3, VOCAB1) and (got[1:] == 0).all()
    h.close()
    j.close()


def test_ft_exports_the_reference_names():
    import repro.ft as jft
    import repro_torch.ft as ft
    for name in ("fold_windows", "rebucketize_tasks", "remesh_fleet",
                 "remesh_plan"):
        assert hasattr(jft, name) and getattr(ft, name) is getattr(el, name)
    assert set(jfleet.__all__) == set(fleet.__all__)


# ---------------------------------------------------------------------------
# deterministic fault machinery
# ---------------------------------------------------------------------------

_PLANS = {
    "default": dict(n_ticks=200, n_procs=8, jobs=("a", "b"), p_kill=0.05),
    "soak": dict(n_ticks=300, n_procs=16, jobs=("x", "y", "z"),
                 p_kill=0.2, p_slow=0.3, p_feed=0.2, max_kill=4),
    "no_jobs": dict(n_ticks=120, n_procs=2, p_kill=0.5, max_kill=3),
}


@pytest.mark.parametrize("kw", list(_PLANS))
@pytest.mark.parametrize("seed", [0, 3, 4, 11, 2024])
def test_fault_plan_generate_equals_reference(seed, kw):
    got = fleet.FaultPlan.generate(seed, **_PLANS[kw])
    want = jfleet.FaultPlan.generate(seed, **_PLANS[kw])
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]
    assert got.events == fleet.FaultPlan.generate(seed, **_PLANS[kw]).events
    kills = [e for e in got.events if e.kind == "kill"]
    assert len(kills) <= _PLANS[kw].get("max_kill", 1)


def test_fault_plan_seeds_differ_and_kill():
    kw = _PLANS["default"]
    a = fleet.FaultPlan.generate(3, **kw)
    assert a.events != fleet.FaultPlan.generate(4, **kw).events
    assert any(e.kind == "kill" for e in a.events)


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        fleet.FaultEvent(0, "meteor")


def test_fault_plan_sorts_events_like_the_reference():
    evs = [(5, "join", (1,)), (0, "slow", (0,)), (2, "kill", (1,)),
           (2, "feed_error", ())]
    got = fleet.FaultPlan(tuple(fleet.FaultEvent(t, k, ranks=r)
                                for t, k, r in evs))
    want = jfleet.FaultPlan(tuple(jfleet.FaultEvent(t, k, ranks=r)
                                  for t, k, r in evs))
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]


def test_injector_delivers_each_event_once_even_late():
    plan = fleet.FaultPlan((fleet.FaultEvent(0, "slow", ranks=(0,)),
                            fleet.FaultEvent(2, "kill", ranks=(1,)),
                            fleet.FaultEvent(5, "join", ranks=(1,))))
    inj = fleet.FaultInjector(plan)
    assert [e.kind for e in inj.poll(0)] == ["slow"]
    assert inj.poll(1) == []
    assert [e.kind for e in inj.poll(7)] == ["kill", "join"]
    assert inj.poll(7) == [] and inj.pending == ()


def test_faulting_source_trips_then_reads_pure(mtokens):
    src = fleet.FaultingSource(ArraySource(mtokens), name="t")
    jsrc = jfleet.FaultingSource(JArraySource(mtokens), name="t")
    clean = np.array(src.read(16, 8))
    src.trip(2)
    jsrc.trip(2)
    for _ in range(2):
        with pytest.raises(fleet.InjectedIOError, match="source 't'") as e:
            src.read(16, 8)
        with pytest.raises(jfleet.InjectedIOError) as je:
            jsrc.read(16, 8)
        assert str(e.value) == str(je.value)
    assert src.faults_fired == jsrc.faults_fired == 2
    assert_equal(src.read(16, 8), clean)                    # purity
    assert_equal(src.read(16, 8), jsrc.read(16, 8))
    assert src.len_elements() == len(mtokens)
    assert isinstance(src.read(0, 4), np.ndarray)


# ---------------------------------------------------------------------------
# the fold program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["8to6", "8to4", "8to6_wrap"])
def test_fold_program_equals_reference(ref, name):
    f = ref["fold"]
    groups = f[name + "_groups"]
    P_new, G, vocab = groups.shape
    fn = remesh.fold_program(8, P_new, vocab, "cpu")
    outs = fn(*(torch.from_numpy(f[name + k])
                for k in ("_groups", "_om", "_os")))
    for got, k in zip(outs, ("_table", "_om_new", "_os_new", "_csum")):
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert_equal(got, f[name + k], k)
    # the replicated checksum is the host twin's int32-wrapped sum
    tables, _ = _fold_windows_cases()[name]
    twin = remesh._wrap_i32_sum(el.fold_windows(tables, P_new))
    assert twin == int(f[name + "_twin"])
    assert_equal(outs[3], np.full((P_new,), twin, np.int32))
    assert remesh._wrap_i32_sum(tables) == jremesh._wrap_i32_sum(tables)
    if name == "8to6_wrap":        # the plain sum left int32: it wrapped
        assert int(el.fold_windows(tables, P_new).astype(np.int64)
                   .sum()) >= 2**31
        assert (outs[0][:, :8] == I32_MAX).any()


def test_fold_program_grows_with_zero_windows():
    rng = np.random.default_rng(2)
    tables = rng.integers(0, 100, size=(4, 10)).astype(np.int32)
    groups = np.zeros((6, 1, 10), np.int32)
    groups[:4, 0] = tables
    rows = np.broadcast_to(np.arange(10, dtype=np.int32) % 4, (6, 10))
    t, om, osp, cs = remesh.fold_program(4, 6, 10, "cpu")(
        torch.from_numpy(groups), torch.from_numpy(rows.copy()),
        torch.from_numpy(rows.copy()))
    assert_equal(t, el.fold_windows(tables, 6))
    assert (t[4:] == 0).all()
    assert_equal(om, rows % 6)
    assert_equal(osp, np.clip(rows, 1, 6))
    assert int(cs[0]) == int(tables.sum())


# ---------------------------------------------------------------------------
# elastic_restore on one rank: same-P path, guards, checksum gate
# ---------------------------------------------------------------------------

VOCAB1 = 64


def wc_cfg(pkg=core, **kw):
    base = dict(usecase=pkg.WordCount(vocab=VOCAB1), backend="1s",
                task_size=16, push_cap=64, n_procs=1, segment=2)
    base.update(kw)
    return pkg.JobConfig(**base)


@pytest.fixture(scope="module")
def tokens1():
    rng = np.random.default_rng(7)
    return rng.integers(0, VOCAB1, size=1024).astype(np.int32)


def _snapshot(tmp_path, tokens, steps=2, **kw):
    mgr = CheckpointManager(str(tmp_path))
    h = core.submit(wc_cfg(**kw), tokens, device="cpu")
    h.step(steps)
    h.checkpoint(mgr).result()
    h.close()
    return mgr


def test_elastic_restore_same_p_delegates_to_seek(tokens1, tmp_path):
    solo = core.submit(wc_cfg(), tokens1, device="cpu").result()
    mgr = _snapshot(tmp_path, tokens1)
    h = fleet.elastic_restore(core.submit(wc_cfg(), tokens1, device="cpu"),
                              mgr)
    assert h.cursor == 4            # two segments of 2: sought, not folded
    assert h.result().records == solo.records == \
        core.wordcount_oracle(tokens1, VOCAB1)


@pytest.mark.parametrize("what", ["backend", "stealing", "partitioner"])
def test_elastic_restore_guards_equal_reference(tokens1, tmp_path, what):
    mgr = _snapshot(tmp_path / "port", tokens1)
    jmgr = JManager(str(tmp_path / "ref"))
    jh = jcore.submit(wc_cfg(jcore), tokens1)
    jh.step(2)
    jh.checkpoint(jmgr).result()
    jh.close()
    kw = {"backend": dict(backend="2s"), "stealing": dict(stealing=True),
          "partitioner": dict(partitioner="sampled")}[what]
    h = core.submit(wc_cfg(**kw), tokens1, device="cpu")
    j = jcore.submit(wc_cfg(jcore, **kw), tokens1)
    with pytest.raises(ValueError) as got:
        fleet.elastic_restore(h, mgr)
    with pytest.raises(ValueError) as want:
        jfleet.elastic_restore(j, jmgr)
    assert str(got.value) == str(want.value)
    if what == "backend":
        assert "backend '1s'" in str(got.value)
    h.close()
    j.close()


def _pad_a_rank(real):
    """Wrap ``CheckpointManager.restore`` to report P_old = P_new + 1 by
    padding a zero rank row: drives elastic_restore down the cross-P fold
    on one rank (the zero row changes no sum)."""
    def patched(self, tree_like, step=None):
        step, tree, extra = real(self, tree_like, step=step)
        pad = {
            "table": lambda a: np.concatenate([a, np.zeros_like(a[:1])]),
            "pending_k": lambda a: np.concatenate(
                [a, np.full_like(a[:1], int(KEY_SENTINEL))]),
            "pending_v": lambda a: np.concatenate([a, np.zeros_like(a[:1])]),
            "owner_map": lambda a: np.concatenate([a, a[:1]]),
            "owner_split": lambda a: np.concatenate([a, a[:1]]),
        }
        tree = tree._replace(**{k: f(np.asarray(getattr(tree, k)))
                                for k, f in pad.items()})
        return step, tree, extra
    return patched


def test_padded_rank_fold_finishes_exact(tokens1, tmp_path, monkeypatch):
    """The one-rank cross-P fold the gate test drives is itself exact
    when the twins agree (P_old 2 -> 1)."""
    mgr = _snapshot(tmp_path, tokens1)
    monkeypatch.setattr(CheckpointManager, "restore",
                        _pad_a_rank(CheckpointManager.restore))
    h = fleet.elastic_restore(core.submit(wc_cfg(), tokens1, device="cpu"),
                              mgr)
    assert h.cursor == 0                              # re-bucketized grid
    assert h.result().records == core.wordcount_oracle(tokens1, VOCAB1)


def test_remesh_checksum_gate_refuses_corrupt_fold(tokens1, tmp_path,
                                                   monkeypatch):
    mgr = _snapshot(tmp_path, tokens1, steps=1)
    monkeypatch.setattr(remesh, "fold_windows",
                        lambda t, n: np.asarray(t) + 1)
    monkeypatch.setattr(CheckpointManager, "restore",
                        _pad_a_rank(CheckpointManager.restore))
    h = core.submit(wc_cfg(), tokens1, device="cpu")
    with pytest.raises(fleet.RemeshChecksumError, match="refusing"):
        fleet.elastic_restore(h, mgr)
    h.close()


def test_remesh_program_handle_contract():
    """The fold as fleetlint's handle: the reference's name, paths and
    replication contract, lint clean at P 8, and its outputs those of
    ``fold_program`` on the same seeded inputs."""
    from repro_torch.analysis import rules
    (h,) = fleet.remesh_program_handles("cpu")
    assert (h.name, h.n_procs) == ("fleet/remesh/fold[16->8]", 8)
    assert h.arg_paths == ("tables", "owner_map", "owner_split")
    assert h.out_paths == ("table", "owner_map", "owner_split", "checksum")
    assert h.replicated_in == ("owner_map", "owner_split")
    assert h.replicated_out == ("owner_map", "owner_split", "checksum")
    assert rules.check_program(h) == []
    ((ins, outs, _),) = rules.run_program(h, watched=False)
    want = remesh.fold_program(16, 8, 64, "cpu")(*ins.values())
    for got, w in zip(outs.values(), want, strict=True):
        assert torch.equal(got, w)
    assert int(outs["checksum"][0]) == remesh._wrap_i32_sum(
        el.fold_windows(ins["tables"].numpy().transpose(1, 0, 2)
                        .reshape(16, 64), 8))


def test_elastic_load_shape_check_equals_reference(tokens1):
    h = core.submit(wc_cfg(), tokens1, device="cpu")
    j = jcore.submit(wc_cfg(jcore), tokens1)
    bad = np.zeros((2, VOCAB1), np.int32)
    row = np.zeros((VOCAB1,), np.int32)
    ids = np.zeros((1, 1), np.int32)
    with pytest.raises(ValueError) as got:
        h.elastic_load(bad, row, row + 1, ids, ids + 1)
    with pytest.raises(ValueError) as want:
        j.elastic_load(bad, row, row + 1, ids, ids + 1)
    assert str(got.value) == str(want.value)
    h.close()
    j.close()


def test_elastic_load_copies_into_the_live_carry(mtokens):
    """The three leaves land in the carry's own buffers (the step graphs
    replay into those), the other rank-shaped leaves keep the fresh
    carry's values, the owner row is broadcast per rank, and the feed
    seeks to column 0 of the new grid."""
    h = core.submit(_mcfg(core, "wc", 6, stealing=True), mtokens,
                    device="cpu")
    h._ensure_segmented()
    before = [t.data_ptr() for t in h.carry]
    fresh = [t.clone() for t in h.carry]
    rng = np.random.default_rng(4)
    table = rng.integers(0, 9, (6, MVOCAB)).astype(np.int32)
    om = (np.arange(MVOCAB) % 6).astype(np.int32)
    ids, reps = el.rebucketize_tasks(h.feed.task_ids_grid,
                                     h.feed.repeats_grid, 3, 6)
    h.elastic_load(torch.from_numpy(table), om, np.ones_like(om), ids, reps)
    assert [t.data_ptr() for t in h.carry] == before
    assert_equal(h.carry.table, table)
    assert_equal(h.carry.owner_map, np.broadcast_to(om, (6, MVOCAB)))
    for f in ("pending_k", "pending_v", "status", "cursor", "work",
              "stolen", "job_work"):
        assert_equal(getattr(h.carry, f), fresh[h.carry._fields.index(f)])
    assert h.cursor == 0 and h.feed.total_columns == ids.shape[1]
    assert h.engine.host_work is None and h._owner_ready
    h.close()


def test_elastic_load_refuses_coded_jobs(mtokens):
    h = core.submit(_mcfg(core, "wc", 4, code_rate=2), mtokens,
                    device="cpu")
    z = np.zeros((4, MVOCAB), np.int32)
    with pytest.raises(ValueError, match="coded"):
        h.elastic_load(z, z[0], z[0] + 1, z[:, :1], z[:, :1] + 1)
    h.close()


# ---------------------------------------------------------------------------
# cross-package restores at P 6 and P 4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P_new", P_NEWS)
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", list(MUSECASES))
def test_reference_snapshot_restores_in_the_port(ref, mtokens, name, part,
                                                 P_new):
    key = f"{name}|{part}"
    mgr = CheckpointManager(str(ref["dir"] / f"ref-{name}-{part}"))
    h = core.submit(_mcfg(core, name, P_new, partitioner=part), mtokens,
                    device="cpu")
    h = fleet.elastic_restore(h, mgr)
    assert h.feed.task_ids_grid.shape[0] == P_new
    got = h.result().records
    assert got == _records(ref["rec"][f"{key}|ref|{P_new}"])
    assert got == _records(ref["rec"][f"{key}|solo"])


@pytest.mark.parametrize("P_new", P_NEWS)
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", list(MUSECASES))
def test_port_snapshot_restores_in_both_packages(ref, mtokens, name, part,
                                                 P_new):
    key = f"{name}|{part}"
    mgr = CheckpointManager(ref["port_dirs"][key])
    h = fleet.elastic_restore(
        core.submit(_mcfg(core, name, P_new, partitioner=part), mtokens,
                    device="cpu"), mgr)
    got = h.result().records
    assert got == _records(ref["rec"][f"{key}|port|{P_new}"])
    assert got == _records(ref["rec"][f"{key}|solo"])


def _oracle(name, tokens):
    uc = _uc(core, name)
    if name == "wc":
        return core.wordcount_oracle(tokens, MVOCAB)
    if name == "hist":
        return core.histogram_oracle(tokens, MVOCAB, 16)
    return core.inverted_index_oracle(tokens, uc.queries, MTASK,
                                      uc.tasks_per_doc, uc.n_docs)


def _own_snapshot_restores(tokens, tmp_path, name, part, P_new, **kw):
    solo = core.submit(_mcfg(core, name, 8, partitioner=part, **kw), tokens,
                       device="cpu").result()
    mgr = CheckpointManager(str(tmp_path))
    h = core.submit(_mcfg(core, name, 8, partitioner=part, **kw), tokens,
                    device="cpu")
    h.step(SNAP_STEP)
    h.checkpoint(mgr).result()
    h.close()
    r = fleet.elastic_restore(
        core.submit(_mcfg(core, name, P_new, partitioner=part, **kw), tokens,
                    device="cpu"), mgr).result()
    return solo, r


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", list(MUSECASES))
def test_stealing_snapshot_restores_at_p6(mtokens, tmp_path, name, part):
    """Stealing does not trace in the reference under the installed jax:
    held to the port's solo run and the oracle."""
    solo, r = _own_snapshot_restores(mtokens, tmp_path, name, part, 6,
                                     stealing=True)
    assert r.records == solo.records
    out, want = r.output, _oracle(name, mtokens)
    assert (np.array_equal(out, want) if name == "hist" else out == want)
    assert r.work_per_rank.shape == (6,)


@pytest.mark.parametrize("P_new", P_NEWS)
@pytest.mark.parametrize("name", list(MUSECASES))
def test_fused_restores_equal_the_reference_unfused(ref, mtokens, tmp_path,
                                                    name, P_new):
    """``fused_map=True`` on the CPU (the plain version): the port's own
    fused snapshot, and the reference's unfused one, restored fused."""
    part = "hash"
    want = _records(ref["rec"][f"{name}|{part}|solo"])
    _, r = _own_snapshot_restores(mtokens, tmp_path, name, part, P_new,
                                  fused_map=True)
    assert r.records == want
    mgr = CheckpointManager(str(ref["dir"] / f"ref-{name}-{part}"))
    h = fleet.elastic_restore(
        core.submit(_mcfg(core, name, P_new, fused_map=True), mtokens,
                    device="cpu"), mgr)
    assert h.result().records == want


# ---------------------------------------------------------------------------
# FleetSupervisor at P 1, beside the reference's in this process
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Boom:
    """Raises when its map runs: a broken tenant (must NOT heal)."""
    vocab: int

    @property
    def window(self):
        return self.vocab

    def map_emit(self, toks, task_id):
        raise ValueError("boom at trace time")


def _supervise(pkg, tmp_path, submit, **kw):
    sup_cls = (fleet if pkg is core else jfleet).FleetSupervisor
    extra = {"device": "cpu"} if pkg is core else {}
    with sup_cls(ckpt_dir=str(tmp_path), **kw, **extra) as sup:
        submit(sup)
        res = sup.run(max_ticks=200)
    return sup, res


def _summary(sup, res):
    return {"records": {n: sorted(r.records.items())
                        for n, r in res.items()},
            "failed": sorted(sup.failed), "n_procs": sup.n_procs,
            "recoveries": [(r.kind, r.p_old, r.p_new, r.jobs_restored,
                            r.jobs_scratch) for r in sup.recoveries],
            "heals": dict(sup._heals),
            "kinds": [t["kind"] for t in sup.timeline]}


def test_supervisor_heals_injected_feed_fault(tokens1, tmp_path):
    out = {}
    for pkg in (core, jcore):
        solo = (core.submit(wc_cfg(), tokens1, device="cpu") if pkg is core
                else jcore.submit(wc_cfg(jcore), tokens1)).result()
        plan = (fleet if pkg is core else jfleet).FaultPlan((
            (fleet if pkg is core else jfleet).FaultEvent(
                0, "feed_error", job="wc", duration=1),))
        sup, res = _supervise(
            pkg, tmp_path / pkg.__name__, lambda s: s.submit(
                wc_cfg(pkg), tokens1, name="wc"),
            n_procs=1, plan=plan, ckpt_every=2, slices_per_tick=2)
        assert not sup.failed and res["wc"].records == solo.records
        out[pkg.__name__] = (_summary(sup, res),
                             sup.entries["wc"].source.faults_fired)
    (got, fired), (want, jfired) = out["repro_torch.core"], out["repro.core"]
    assert got == want
    assert "healed" in got["kinds"] and got["heals"] == {"wc": 1}
    assert fired == jfired == 1


def test_supervisor_isolates_real_failures(tokens1, tmp_path):
    out = {}
    for pkg in (core, jcore):
        def submit(s):
            s.submit(wc_cfg(pkg), tokens1, name="good")
            s.submit(wc_cfg(pkg, usecase=Boom(vocab=VOCAB1)), tokens1,
                     name="bad")
        sup, res = _supervise(pkg, tmp_path / pkg.__name__, submit,
                              n_procs=1, ckpt_every=0, slices_per_tick=2)
        assert "boom" in str(sup.failed["bad"]) and sup.done
        out[pkg.__name__] = _summary(sup, res)
    assert out["repro_torch.core"] == out["repro.core"]
    assert out["repro_torch.core"]["failed"] == ["bad"]
    assert list(out["repro_torch.core"]["records"]) == ["good"]


def test_supervisor_restart_discipline_skips_snapshots(tokens1, tmp_path):
    """restore_on_remesh=False, fig13's control arm: snapshots are taken,
    but a re-mesh restarts every job from scratch, still exact."""
    out = {}
    for pkg in (core, jcore):
        f = fleet if pkg is core else jfleet
        sup, res = _supervise(
            pkg, tmp_path / pkg.__name__,
            lambda s: s.submit(wc_cfg(pkg), tokens1, name="wc"),
            n_procs=1, plan=f.FaultPlan((f.FaultEvent(2, "kill",
                                                      ranks=(0,)),)),
            ckpt_every=1, slices_per_tick=1, restore_on_remesh=False)
        out[pkg.__name__] = _summary(sup, res)
    got = out["repro_torch.core"]
    assert got == out["repro.core"]
    assert got["recoveries"] == [("kill", 1, 1, 0, 1)]
    assert dict(got["records"]["wc"]) == core.wordcount_oracle(tokens1,
                                                               VOCAB1)


def test_supervisor_rejects_duplicate_names(tokens1, tmp_path):
    with fleet.FleetSupervisor(n_procs=1, ckpt_dir=str(tmp_path),
                               device="cpu") as sup:
        sup.submit(wc_cfg(), tokens1, name="x")
        with pytest.raises(ValueError, match="duplicate"):
            sup.submit(wc_cfg(), tokens1, name="x")


def test_supervisor_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.FleetSupervisor(n_procs=1, ckpt_dir=str(tmp_path))


def test_supervisor_stats_keys_equal_reference(tokens1, tmp_path):
    sups = {}
    for pkg in (core, jcore):
        sup, _ = _supervise(pkg, tmp_path / pkg.__name__,
                            lambda s: s.submit(wc_cfg(pkg), tokens1,
                                               name="wc"),
                            n_procs=1, ckpt_every=2, slices_per_tick=2)
        sups[pkg.__name__] = sup.stats()
    got, want = sups["repro_torch.core"], sups["repro.core"]
    assert set(got) == set(want)
    assert got["results"] == want["results"] == ["wc"]
    assert got["n_procs"] == want["n_procs"] == 1


# ---------------------------------------------------------------------------
# the reference's fleet of four: kill to P 6; and the join back to P 8
# ---------------------------------------------------------------------------

def _run_port_fleet(tmp_path, events):
    data = _fleet_data()
    cases = _fleet_cases(core)
    solo = {n: core.submit(_fcfg(core, cases[n]), data[n],
                           device="cpu").result() for n in data}
    sup = fleet.FleetSupervisor(n_procs=8, ckpt_dir=str(tmp_path),
                                plan=fleet.FaultPlan(events), ckpt_every=1,
                                slices_per_tick=4, device="cpu")
    for n in data:
        sup.submit(_fcfg(core, cases[n]), data[n], name=n)
    res = sup.run(max_ticks=500)
    sup.close()
    return sup, res, solo


def test_fleet_of_four_survives_kill_to_p6(ref, tmp_path):
    sup, res, solo = _run_port_fleet(
        tmp_path, (fleet.FaultEvent(3, "kill", ranks=(1, 5)),))
    want = ref["rec"]["fleet|stats"]
    assert not sup.failed and want["failed"] == []
    assert set(res) == set(solo)
    for n in solo:
        assert res[n].records == solo[n].records, n
        assert res[n].records == _records(ref["rec"][f"fleet|{n}"]), n
    [r] = sup.recoveries
    assert (r.kind, r.p_old, r.p_new) == ("kill", 8, 6)
    assert r.jobs_restored == 4 and r.jobs_scratch == 0
    assert [[r.kind, r.p_old, r.p_new, r.jobs_restored,
             r.jobs_scratch]] == want["recoveries"]
    assert sup.n_procs == want["n_procs"] == 6
    assert [e.source.faults_fired for e in sup.entries.values()] == \
        want["faults_fired"]
    assert [t["kind"] for t in sup.timeline] == want["kinds"] == ["kill"]


def test_fleet_grows_back_on_join(tmp_path):
    """Kill to P 6, then a join back to P 8 (a campaign the reference's
    tests do not run): every job equal to its solo run, and the join's
    live snapshot loses no work."""
    sup, res, solo = _run_port_fleet(
        tmp_path, (fleet.FaultEvent(3, "kill", ranks=(1, 5)),
                   fleet.FaultEvent(6, "join", ranks=(1, 5))))
    assert not sup.failed
    for n in solo:
        assert res[n].records == solo[n].records, n
    assert [(r.kind, r.p_old, r.p_new) for r in sup.recoveries] == [
        ("kill", 8, 6), ("join", 6, 8)]
    assert sup.recoveries[1].jobs_scratch == 0
    assert sup.n_procs == 8
    assert sup.scheduler.jobs[0].handle.spec.n_procs == 8
