"""Checkpoint, restore and re-planning in the port, against the JAX package.

``repro_torch.ckpt.CheckpointManager`` and the handle's ``checkpoint``,
``restore``, ``load``, ``replan``, ``cursor`` and
``remaining_task_ids`` on ``device="cpu"``, for both backends: a
snapshot round-trips and the restored job finishes with the
uninterrupted job's records; a snapshot written by the JAX package after
one segment (P = 8, one subprocess) restores into the port and finishes
with JAX's records, and the port's snapshot at the same point has the
same keys, shapes, dtypes and values; the guards raise; re-planning and
seeking finish exactly and drop a prefetch of the old plan; an async
snapshot holds the carry as it was at the call; the straggler functions
equal JAX's.
"""
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.ft.straggler as jstraggler  # noqa: E402
import repro_torch.core as core  # noqa: E402
import repro_torch.ft.straggler as straggler  # noqa: E402
from repro.ckpt.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import windows  # noqa: E402
from repro_torch.data.corpus import imbalance_repeats  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

VOCAB, N, TASK, CAP, P, SEG = 300, 8192, 64, 8, 8, 4
T = -(-(-(-N // TASK)) // P)
BACKENDS = ("1s", "2s")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return (rng.zipf(1.4, N) % VOCAB).astype(np.int32)


REPS = imbalance_repeats(P, T, mode="unbalanced")


def _cfg(backend, **kw):
    return core.JobConfig(core.WordCount(VOCAB), backend=backend,
                          task_size=TASK, push_cap=CAP, n_procs=P,
                          segment=SEG, **kw)


def _submit(backend, data, **kw):
    return core.submit(_cfg(backend, **kw), data, device="cpu",
                       repeats=REPS)


@pytest.fixture(scope="module")
def uninterrupted(data):
    return {b: _submit(b, data).result().records for b in BACKENDS}


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(16, 8)).astype(
                np.float32)),
            "nested": {"b": torch.from_numpy(rng.integers(0, 9, (4,)).astype(
                np.int32)), "c": rng.normal(size=(3, 3))}}


def test_save_restore_roundtrip_keep_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in range(5):
        mgr.save_async(s, _tree(s), extra={"step": s})
    mgr.wait()
    assert mgr.steps() == [2, 3, 4] and mgr.latest_step() == 4
    step, got, extra = mgr.restore(_tree(0), step=3)
    assert step == 3 and extra == {"step": 3}
    want = _tree(3)
    assert_equal(got["a"], want["a"])
    assert_equal(got["nested"]["b"], want["nested"]["b"])
    assert_equal(got["nested"]["c"], want["nested"]["c"])
    assert got["a"].dtype == torch.float32 and isinstance(
        got["nested"]["c"], np.ndarray)
    os.makedirs(tmp_path / "step-9")            # no manifest: torn
    assert mgr.latest_step() == 4
    keys = set(np.load(tmp_path / "step-4" / "arrays.npz").files)
    assert keys == {"a", "nested/b", "nested/c"}


def test_manifest_writes_arrays_as_the_lists_they_hold(tmp_path):
    """Arrays in ``extra`` (the handle's grids) come back as lists, the
    same array's text reused and a changed one's written anew."""
    mgr = CheckpointManager(str(tmp_path), keep=4)
    grid = np.arange(24, dtype=np.int32).reshape(3, 8)
    for s, g in enumerate((grid, grid.copy(), grid[:, ::-1].copy())):
        mgr.save(s, {"x": torch.zeros(2)},
                 extra={"grid": g, "k": 5, "s": "a\0b", "none": None})
        assert mgr.peek(s)[1] == {"grid": g.tolist(), "k": 5, "s": "a\0b",
                                  "none": None}
    assert len(mgr._texts) == 2
    manifest = json.loads((tmp_path / "step-2" / "manifest.json").read_text())
    assert set(manifest) == {"step", "n_leaves", "extra", "wall"}
    assert manifest["step"] == 2 and manifest["n_leaves"] == 1


def test_peek_and_the_backend_guard_raise_as_the_reference_does(
        tmp_path, data):
    with pytest.raises(AssertionError):
        JManager(str(tmp_path / "j")).peek()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "t")).peek()
    # a "1s" snapshot into a "2s" handle, in each package
    jcfg = jcore.JobConfig(jcore.WordCount(VOCAB), backend="1s",
                           task_size=TASK, push_cap=CAP, n_procs=1,
                           segment=SEG)
    jh = jcore.submit(jcfg, data)
    jh.step()
    jm = JManager(str(tmp_path / "jsnap"))
    jh.checkpoint(jm)
    jm.wait()
    jh.close()
    with pytest.raises(ValueError, match="backend"):
        jcore.submit(jcore.JobConfig(jcore.WordCount(VOCAB), backend="2s",
                                     task_size=TASK, push_cap=CAP,
                                     n_procs=1, segment=SEG),
                     data).restore(jm)
    h = _submit("1s", data)
    h.step()
    mgr = CheckpointManager(str(tmp_path / "tsnap"))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    with pytest.raises(ValueError, match="backend"):
        _submit("2s", data).restore(mgr)
    assert mgr.peek()[1]["backend"] == "1s"


@pytest.mark.parametrize("key,value", [("stealing", True),
                                       ("code_rate", 2),
                                       ("partitioner", "sampled"),
                                       ("coslots", 2)])
def test_restore_guards_raise(tmp_path, data, key, value):
    h = _submit("1s", data)
    h.step()
    mgr = CheckpointManager(str(tmp_path))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    path = tmp_path / f"step-{SEG}" / "manifest.json"
    manifest = json.loads(path.read_text())
    manifest["extra"][key] = value
    path.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match=key):
        _submit("1s", data).restore(mgr)


# ---------------------------------------------------------------------------
# the port's own snapshots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_round_trips_and_the_restored_job_finishes(
        tmp_path, data, uninterrupted, backend):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    h = _submit(backend, data)
    h.step()
    h.checkpoint(mgr)
    h.step()
    h.checkpoint(mgr)
    mgr.wait()
    at = windows.carry_to_numpy(h.carry)
    assert mgr.steps() == [SEG, 2 * SEG] and h.cursor == 2 * SEG
    assert h.remaining_task_ids().tolist() == sorted(
        t for t in h.feed.task_ids_grid[:, 2 * SEG:].ravel().tolist()
        if t >= 0)
    assert h.result().records == uninterrupted[backend]
    h2 = _submit(backend, data).restore(mgr)
    assert h2.cursor == 2 * SEG
    for f, a, b in zip(windows.EngineCarry._fields,
                       windows.carry_to_numpy(h2.carry), at):
        assert_equal(a, b, f)
    assert h2.result().records == uninterrupted[backend]
    h3 = _submit(backend, data).restore(mgr, step=SEG)   # the older one
    assert h3.cursor == SEG
    assert h3.result().records == uninterrupted[backend]


@pytest.mark.parametrize("backend", BACKENDS)
def test_load_and_seek_finish_exactly(data, uninterrupted, backend):
    h = _submit(backend, data)
    h.step()
    snap = windows.carry_to_numpy(h.carry)
    h.step()
    h.step()
    h.load(snap, SEG)                             # back one segment later
    assert h.cursor == SEG
    assert h.result().records == uninterrupted[backend]


def test_async_snapshot_holds_the_carry_at_the_call(tmp_path, data):
    """The worker is held until further segments have folded into the
    window in place; the snapshot still holds the carry of the call."""
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    mgr._pool.submit(gate.wait, 60)
    h = _submit("2s", data)
    h.step()
    at = windows.carry_to_numpy(h.carry)
    fut = h.checkpoint(mgr)
    h.step()
    h.step()
    assert not (windows.carry_to_numpy(h.carry).table == at.table).all()
    gate.set()
    fut.result(timeout=60)
    _, got, _ = mgr.restore(h.carry)
    for f, a, b in zip(windows.EngineCarry._fields,
                       windows.carry_to_numpy(got), at):
        assert_equal(a, b, f)
    h.close()


# ---------------------------------------------------------------------------
# re-planning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_replan_halfway_finishes_exactly(data, uninterrupted, backend):
    h = _submit(backend, data)
    h.step(2)
    remaining = h.remaining_task_ids()
    tracker = straggler.ThroughputTracker(n_procs=P)
    tracker.update(np.array([1.0, 4.0] + [1.0] * (P - 2)))
    grid = straggler.replan_handle(h, tracker)
    assert sorted(grid[grid >= 0].tolist()) == remaining.tolist()
    assert_equal(h.feed.task_ids_grid[:, 2 * SEG:], grid)
    by_task = dict(zip(_submit(backend, data).feed.task_ids_grid.ravel()
                       .tolist(), REPS.ravel().tolist()))
    reps = h.feed.repeats_grid[:, 2 * SEG:]
    assert all(reps[i] == by_task[int(grid[i])]
               for i in zip(*np.nonzero(grid >= 0)))
    res = h.result()
    assert res.records == uninterrupted[backend]
    assert int(res.work_per_rank.sum()) == int(REPS.sum())


def test_replan_drops_the_prefetch_of_the_old_plan(data):
    h = _submit("1s", data)
    h.step()
    feed = h.feed
    old = feed._pending
    old[1].result(timeout=60)                     # the old plan's read
    rem = h.remaining_task_ids()
    grid = np.full((P, len(rem)), -1, np.int32)
    grid[0] = rem                                 # everything on rank 0
    h.replan(grid)
    assert feed._pending is not old and feed._pending[2] == old[2] + 1
    assert (old[0], old[2]) not in feed.stats._live
    seg = feed.next_segment()
    want = np.full((P, SEG), -1, np.int32)
    want[0] = rem[:SEG]
    assert_equal(seg.task_ids, want)
    assert feed.stats.prefetch_hits == 1          # the new plan's read
    with pytest.raises(ValueError, match="exactly"):
        h.replan(grid[:, :3])
    h.close()


def test_seek_repositions_without_replaying(data):
    h = _submit("1s", data, )
    feed = h.feed
    before = feed.stats.bytes_read
    feed.seek(3 * SEG)
    seg = feed.next_segment()
    assert_equal(seg.task_ids, feed.task_ids_grid[:, 3 * SEG:4 * SEG])
    assert feed.consumed_task_ids().tolist() == sorted(
        feed.task_ids_grid[:, :4 * SEG].ravel().tolist())
    h.close()
    assert feed.stats.bytes_read - before <= 3 * P * SEG * TASK * 4


# ---------------------------------------------------------------------------
# the JAX package's snapshots
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_snapshots(devices8, data, tmp_path_factory):
    """One 8-device JAX subprocess: a WordCount job of each backend,
    checkpointed by ``repro.ckpt.CheckpointManager`` after one segment,
    then finished; its records."""
    d = tmp_path_factory.mktemp("jax_ckpt")
    np.savez(d / "in.npz", data=data, reps=REPS)
    devices8(f"""
        import numpy as np
        import repro.core as core
        from repro.ckpt.checkpoint import CheckpointManager
        inp = np.load({str(d / "in.npz")!r})
        res = {{}}
        for backend in {BACKENDS!r}:
            cfg = core.JobConfig(core.WordCount({VOCAB}), backend=backend,
                                 task_size={TASK}, push_cap={CAP},
                                 n_procs={P}, segment={SEG})
            h = core.submit(cfg, inp["data"], repeats=inp["reps"])
            h.step()
            mgr = CheckpointManager({str(d)!r} + "/" + backend)
            h.checkpoint(mgr)
            mgr.wait()
            res[backend] = np.array(sorted(h.result().records.items()))
        np.savez({str(d / "out.npz")!r}, **res)
        print("OK")
    """)
    return d, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_jax_snapshot_restores_into_the_port(jax_snapshots, data, backend):
    d, records = jax_snapshots
    h = _submit(backend, data).restore(CheckpointManager(str(d / backend)))
    assert h.cursor == SEG
    res = h.result()
    assert_equal(np.array(sorted(res.records.items())), records[backend])


@pytest.mark.parametrize("backend", BACKENDS)
def test_port_snapshot_has_the_jax_snapshots_form(jax_snapshots, tmp_path,
                                                  data, backend):
    d, _ = jax_snapshots
    h = _submit(backend, data)
    h.step()
    mgr = CheckpointManager(str(tmp_path))
    h.checkpoint(mgr)
    mgr.wait()
    h.close()
    jdir, tdir = d / backend / f"step-{SEG}", tmp_path / f"step-{SEG}"
    jarr, tarr = np.load(jdir / "arrays.npz"), np.load(tdir / "arrays.npz")
    assert sorted(tarr.files) == sorted(jarr.files) == sorted(
        "." + f for f in windows.EngineCarry._fields)
    for k in jarr.files:
        assert tarr[k].dtype == jarr[k].dtype, k
        assert_equal(tarr[k], jarr[k], k)
    jman = json.loads((jdir / "manifest.json").read_text())
    tman = json.loads((tdir / "manifest.json").read_text())
    assert set(tman) == set(jman)
    assert set(tman["extra"]) == set(jman["extra"])
    for k in ("cursor", "backend", "stealing", "coslots", "fused_map",
              "code_rate", "partitioner", "task_ids", "repeats"):
        assert tman["extra"][k] == jman["extra"][k], k


# ---------------------------------------------------------------------------
# the straggler functions
# ---------------------------------------------------------------------------

class _Handle:
    """What the straggler functions read of a handle (weakly keyable,
    as the hook's trackers need)."""

    def __init__(self, remaining, stealing, exhausted):
        self.replans = []
        self.remaining_task_ids = lambda: remaining
        self.replan = self.replans.append
        self.config = SimpleNamespace(stealing=stealing, n_procs=P)
        self.feed = SimpleNamespace(exhausted=exhausted)


def _stub(remaining, stealing=False, exhausted=False):
    h = _Handle(remaining, stealing, exhausted)
    return h.replans, h


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    secs = rng.uniform(0.5, 4.0, (5, P))
    trackers = [mod.ThroughputTracker(n_procs=P, alpha=0.3)
                for mod in (straggler, jstraggler)]
    for s in secs:
        for tr in trackers:
            tr.update(s)
    work = rng.integers(0, 5, (P,))
    for tr in trackers:
        tr.update_work(work, 0.7)
    assert_equal(trackers[0].rate, trackers[1].rate)
    assert_equal(trackers[0].is_straggler(0.6), trackers[1].is_straggler(0.6))
    ids = rng.permutation(200)[: rng.integers(1, 200)].tolist()
    for per_seg in (len(ids), 17, 1000):
        assert_equal(straggler.rebalance_tasks(ids, trackers[0].rate,
                                               per_seg),
                     jstraggler.rebalance_tasks(ids, trackers[1].rate,
                                                per_seg))
    result = SimpleNamespace(work_per_rank=rng.integers(1, 9, (P,)),
                             wall_time=1.7)
    assert_equal(straggler.tracker_from_result(result, 0.4).rate,
                 jstraggler.tracker_from_result(result, 0.4).rate)
    remaining = np.sort(rng.permutation(300)[:90]).astype(np.int32)
    for drift in (0.0, 1.5, 100.0):
        for stealing in (False, True):
            (got_t, ht), (got_j, hj) = (_stub(remaining, stealing),
                                        _stub(remaining, stealing))
            a = straggler.outer_rebalance(ht, trackers[0], drift)
            b = jstraggler.outer_rebalance(hj, trackers[1], drift)
            assert (a is None) == (b is None) and len(got_t) == len(got_j)
            if a is not None:
                assert_equal(a, b)
                assert_equal(got_t[0], got_j[0])
    assert_equal(straggler.plan_next_segment(_stub(remaining)[1],
                                             trackers[0], 40),
                 jstraggler.plan_next_segment(_stub(remaining)[1],
                                              trackers[1], 40))
    hooks = (straggler.rebalance_hook(0.5), jstraggler.rebalance_hook(0.5))
    stubs = (_stub(remaining), _stub(remaining))
    slice_stats = SimpleNamespace(seconds=0.9, work_per_rank=work)
    outs = [hook(st[1], slice_stats) for hook, st in zip(hooks, stubs)]
    assert_equal(outs[0], outs[1])
    done = [hook(_stub(remaining, exhausted=True)[1], slice_stats)
            for hook in hooks]
    assert done == [None, None]


# ---------------------------------------------------------------------------
# training states across the packages
# ---------------------------------------------------------------------------

def _train_states(dtype):
    """The same olmo-smoke TrainState in each package: parameters of the
    reference's ``init_model`` in ``dtype``, moments of seeded normals in
    ``dtype``, step 5."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.config import TrainConfig as JTrain
    from repro.configs import registry as jreg
    from repro.models import transformer as jtf
    from repro.optim.adamw import AdamWState as JAdam
    from repro.train import train_step as jts
    from repro_torch.config import TrainConfig
    from repro_torch.configs import registry as treg
    from repro_torch.models import convert
    from repro_torch.train import train_step as tts

    jcfg, tcfg = (dataclasses.replace(reg.get_smoke_config("olmo-1b"),
                                      dtype=dtype, param_dtype=dtype)
                  for reg in (jreg, treg))
    jp = jtf.init_model(jcfg, jax.random.key(2))
    rng = np.random.default_rng(9)
    mu, nu = (jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape), p.dtype), jp) for _ in range(2))
    jstate = jts.init_train_state(jcfg, JTrain(moment_dtype=dtype), jp) \
        ._replace(opt=JAdam(jnp.int32(5), mu, nu))

    cpu = torch.device("cpu")
    model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                      cpu)
    tstate = tts.init_train_state(tcfg, TrainConfig(moment_dtype=dtype),
                                  model)
    for dst, tree in ((tstate.opt.mu, mu), (tstate.opt.nu, nu)):
        src = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, tree),
                                        cpu)
        for d, s in zip(dst, src.parameters()):
            d.copy_(s.detach())
    tstate.opt.step.fill_(5)
    return tcfg, jstate, tstate


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _state_leaves(tcfg, tstate) -> dict:
    """The port's state as ``{reference leaf key: numpy}`` (bf16 as its
    16-bit patterns)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.train import train_step as tts
    out = {}
    for path, t in _flatten(tts.state_tree(tcfg, tstate)):
        t = t.detach()
        out["/".join(path)] = (t.view(torch.int16).numpy().view(np.uint16)
                               if t.dtype == torch.bfloat16 else t.numpy())
    return out


def _jax_leaves(tree) -> dict:
    import jax
    from repro.ckpt.checkpoint import _leaf_key
    return {_leaf_key(p): _bits(jax.device_get(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_train_state_snapshot_restores_in_jax_bit_for_bit(tmp_path,
                                                                dtype):
    """A ``TrainState`` written by the port (``state_tree`` under the
    reference's leaf keys; a bf16 leaf as raw ``V2``, the form the
    reference's npz holds) restores in the reference. Before the port
    wrote bf16 this way its ``save`` raised on a bf16 leaf."""
    import jax
    from repro_torch.train import train_step as tts
    tcfg, jstate, tstate = _train_states(dtype)
    CheckpointManager(str(tmp_path)).save(
        5, tts.state_tree(tcfg, tstate), extra={"next_step": 6})
    step, got, extra = JManager(str(tmp_path)).restore(
        jax.eval_shape(lambda: jstate))
    assert (step, extra) == (5, {"next_step": 6})
    want, have = _jax_leaves(jstate), _jax_leaves(got)
    assert sorted(have) == sorted(want)
    assert sorted(np.load(tmp_path / "step-5" / "arrays.npz").files) == \
        sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        assert_equal(have[k], want[k], k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_jax_train_state_snapshot_restores_in_the_port_bit_for_bit(tmp_path,
                                                                    dtype):
    from repro_torch.config import TrainConfig
    from repro_torch.models.transformer import init_model
    from repro_torch.train import train_step as tts
    tcfg, jstate, _ = _train_states(dtype)
    JManager(str(tmp_path)).save(5, jstate, extra={"next_step": 6})
    fresh = tts.init_train_state(tcfg, TrainConfig(moment_dtype=dtype),
                                 init_model(tcfg, 11, device="cpu"))
    step, extra = tts.restore_state(CheckpointManager(str(tmp_path)), tcfg,
                                    fresh)
    assert (step, extra) == (5, {"next_step": 6})
    want, have = _jax_leaves(jstate), _state_leaves(tcfg, fresh)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        assert_equal(have[k], want[k], k)
    assert all(p.requires_grad for p in fresh.params.parameters())


def test_bf16_leaf_round_trips_between_the_packages(tmp_path):
    """One bf16 leaf and one 0-d int32 leaf: the port's snapshot restores
    in the reference and the reference's in the port, bit for bit."""
    import jax.numpy as jnp
    bits = np.array([0x3FC0, 0xC010, 0x7F80, 0x0001, 0x8000], np.uint16)
    leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    tree = {"w": leaf, "n": torch.tensor(7, dtype=torch.int32)}
    CheckpointManager(str(tmp_path / "t")).save(0, tree)
    like = {"w": jnp.zeros((5,), jnp.bfloat16), "n": jnp.int32(0)}
    _, got, _ = JManager(str(tmp_path / "t")).restore(like)
    assert_equal(_bits(got["w"]), bits)
    assert int(got["n"]) == 7 and np.asarray(got["n"]).shape == ()
    JManager(str(tmp_path / "j")).save(0, got)
    _, back, _ = CheckpointManager(str(tmp_path / "j")).restore(
        {"w": torch.zeros(5, dtype=torch.bfloat16),
         "n": torch.tensor(0, dtype=torch.int32)})
    assert back["w"].dtype == torch.bfloat16 and back["n"].shape == ()
    assert_equal(back["w"].view(torch.int16).numpy().view(np.uint16), bits)
    assert int(back["n"]) == 7
