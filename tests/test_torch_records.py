"""Record machinery of the PyTorch port against the JAX reference.

kv, windows, combine, partition, collectives, use-cases and the numpy
copies (planner, sources, imbalance grid): the same seeded numpy inputs
go through ``repro`` (JAX on the CPU) and ``repro_torch`` (torch on the
CPU), and every output must be equal bit for bit (tolerance 0: the path
is int32). The port batches P ranks on a leading dim; the reference runs
per rank, so its results are compared row by row.
"""
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.core import combine as jcombine  # noqa: E402
from repro.core import kv as jkv  # noqa: E402
from repro.core import partition as jpart  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core import usecase as jusecase  # noqa: E402
from repro.core import usecases as jusecases  # noqa: E402
from repro.core import windows as jwin  # noqa: E402
from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import source as jsource  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro_torch.core import combine, kv, partition, planner  # noqa: E402
from repro_torch.core import usecase, usecases, windows  # noqa: E402
from repro_torch.data import corpus, source  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from torch_parity import SENT, assert_equal, to_torch  # noqa: E402

SAT = 2**31 - 1


def _rows(fn, *arrays):
    """Run a per-rank JAX function over the leading dim, stacking each
    output (jax arrays) into numpy."""
    outs = [fn(*(jnp.asarray(a[r]) for a in arrays))
            for r in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs])
                     for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


# ---------------------------------------------------------------------------
# kv
# ---------------------------------------------------------------------------

def test_mix32_edge_values_and_random():
    x = np.array([0, -1, SAT, -SAT - 1, 1, 12345], np.int32)
    x = np.concatenate([x, np.random.default_rng(0).integers(
        -2**31, 2**31, 200, dtype=np.int64).astype(np.int32)])
    got = kv.mix32(to_torch(x)).numpy()
    want = np.asarray(jkv.mix32(jnp.asarray(x))).astype(np.int64)
    assert_equal(got, want)
    assert got.min() >= 0 and got.max() < 2**32


@pytest.mark.parametrize("P", [1, 3, 8])
def test_owner_of(P):
    keys = np.random.default_rng(P).integers(0, 10**6, (4, 64)).astype(
        np.int32)
    assert_equal(kv.owner_of(to_torch(keys), P),
                 np.asarray(jkv.owner_of(jnp.asarray(keys), P)))


def _records(kind, P=4, L=48, vocab=20, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, vocab, (P, L)).astype(np.int32)
    vals = rng.integers(-50, 100, (P, L)).astype(np.int32)
    if kind == "sentinels":
        keys[rng.random((P, L)) < 0.3] = SENT
        keys[0] = SENT                                   # an empty row
    elif kind == "all_duplicates":
        keys[:] = keys[:, :1]
    elif kind == "near_sat":
        vals = (SAT - rng.integers(0, 4, (P, L))).astype(np.int32)
    return keys, vals


@pytest.mark.parametrize("kind,capacity", [
    ("random", 48), ("sentinels", 48), ("all_duplicates", 48),
    ("near_sat", 48),
    ("random", 20),          # n_unique == capacity: the ghost slot
    ("random", 7),           # capacity < n_unique: truncated
    ("random", 64),          # capacity > L
])
def test_local_reduce(kind, capacity):
    keys, vals = _records(kind)
    if capacity == 20:
        keys[:, :20] = np.arange(20)           # every row: 20 unique keys
    got = kv.local_reduce(to_torch(keys), to_torch(vals), capacity)
    want = _rows(lambda k, v: jkv.local_reduce(k, v, capacity), keys, vals)
    for g, w, name in zip(got, want, ("keys", "vals", "n_unique")):
        assert_equal(g, w, name)


def test_local_reduce_repeated_wrap_negative_rep_1_2_3():
    """The repeat recurrence is not value-preserving on wrap-negative
    sums: rep 1, 2, 3 give different records, and each rank of one batch
    must keep exactly its own rep's result."""
    keys = np.tile(np.array([3, 3, 5, 7, 7, 7], np.int32), (3, 1))
    vals = np.tile(np.array([SAT, 5, 1, SAT, SAT, 2], np.int32), (3, 1))
    rep = np.array([1, 2, 3], np.int32)
    uk, uv = kv.local_reduce_repeated(to_torch(keys), to_torch(vals), 6,
                                      to_torch(rep), 3)
    for r in range(3):
        wk, wv = jkv.local_reduce_repeated(jnp.asarray(keys[r]),
                                           jnp.asarray(vals[r]), 6,
                                           jnp.int32(rep[r]))
        assert_equal(uk[r], wk, f"rep={rep[r]}")
        assert_equal(uv[r], wv, f"rep={rep[r]}")
    # key 3 (slot 0): -2147483644, then 8, then -2147483644 again
    assert uv[:, 0].tolist() == [-2147483644, 8, -2147483644]


@pytest.mark.parametrize("max_rep", [1, 2, 3])
def test_local_reduce_repeated_near_sat(max_rep):
    keys, vals = _records("near_sat", P=6, L=24, vocab=6, seed=max_rep)
    rep = np.random.default_rng(max_rep).integers(1, max_rep + 1, 6)
    rep = rep.astype(np.int32)
    rep[0] = max_rep
    uk, uv = kv.local_reduce_repeated(to_torch(keys), to_torch(vals), 24,
                                      to_torch(rep), max_rep)
    wk, wv = _rows(lambda k, v, r: jkv.local_reduce_repeated(k, v, 24, r),
                   keys, vals, rep)
    assert_equal(uk, wk)
    assert_equal(uv, wv)


def test_merge_sorted():
    rng = np.random.default_rng(5)
    a = np.sort(rng.choice(40, (3, 12)), axis=1).astype(np.int32)
    b = np.sort(rng.choice(40, (3, 12)), axis=1).astype(np.int32)
    va = rng.integers(0, 9, (3, 12)).astype(np.int32)
    vb = rng.integers(0, 9, (3, 12)).astype(np.int32)
    got = kv.merge_sorted(*map(to_torch, (a, va, b, vb)), 16)
    want = _rows(lambda *x: jkv.merge_sorted(*x, 16), a, va, b, vb)
    for g, w in zip(got, want):
        assert_equal(g, w)


@pytest.mark.parametrize("P,cap,given", [(4, 3, False), (4, 16, False),
                                         (3, 2, True), (8, 1, True)])
def test_bucketize(P, cap, given):
    keys, vals = _records("sentinels", P=5, L=32, vocab=64, seed=P + cap)
    owners = None
    if given:
        rng = np.random.default_rng(cap)
        owners = rng.integers(0, P + 1, keys.shape).astype(np.int32)
    got = kv.bucketize(to_torch(keys), to_torch(vals), P, cap,
                       owners=None if owners is None else to_torch(owners))

    def flat(r):
        return r[0], r[1], r[2], r[3][0], r[3][1]

    if owners is None:
        want = _rows(lambda k, v: flat(jkv.bucketize(k, v, P, cap)),
                     keys, vals)
    else:
        want = _rows(lambda k, v, o: flat(jkv.bucketize(k, v, P, cap,
                                                        owners=o)),
                     keys, vals, owners)
    bk, bv, counts, (ofk, ofv) = got
    for g, w, name in zip((bk, bv, counts, ofk, ofv), want,
                          ("bk", "bv", "counts", "ofk", "ofv")):
        assert_equal(g, w, name)


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 4, 8])
def test_lookup_owner_split_keys(P):
    """Split keys pick a replica by the mixed task id (-1 included);
    sentinel and out-of-window keys go to the ghost owner P."""
    V = 64
    rng = np.random.default_rng(P)
    omap = rng.integers(0, P, (P, V)).astype(np.int32)
    osplit = np.ones((P, V), np.int32)
    osplit[rng.random((P, V)) < 0.4] = rng.integers(2, P + 2)
    keys = rng.integers(-4, V + 4, (P, 40)).astype(np.int32)
    keys[:, :3] = SENT
    tid = np.array([-1, 0, 7, 2**31 - 1, 5, 123456, 3, 9][:P], np.int32)
    got = partition.lookup_owner(to_torch(omap), to_torch(osplit),
                                 to_torch(keys), to_torch(tid), P)
    want = _rows(lambda m, s, k, t: jpart.lookup_owner(m, s, k, t, P),
                 omap, osplit, keys, tid)
    assert_equal(got, want)


@pytest.mark.parametrize("P", [1, 5, 8])
def test_hash_owner_map(P):
    assert_equal(partition.hash_owner_map(300, P),
                 jpart.hash_owner_map(300, P))
    om, osp = partition.HashPartitioner().build(np.zeros(300), P)
    jom, josp = jpart.HashPartitioner().build(np.zeros(300), P)
    assert_equal(om, jom)
    assert_equal(osp, josp)


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def test_dense_window_put_follows_reference_scatter():
    """Sentinel and out-of-range keys drop; keys in [-V, 0) wrap, as the
    reference's scatter does."""
    V = 16
    rng = np.random.default_rng(3)
    table = rng.integers(-5, 5, (3, V)).astype(np.int32)
    keys = rng.integers(-2 * V, 2 * V, (3, 40)).astype(np.int32)
    keys[:, :4] = SENT
    vals = rng.integers(-SAT, SAT, (3, 40)).astype(np.int32)
    got = windows.DenseWindow(to_torch(table).clone()).put(
        to_torch(keys), to_torch(vals)).table
    want = _rows(lambda t, k, v: jwin.DenseWindow(t).put(k, v).table,
                 table, keys, vals)
    assert_equal(got, want)


@pytest.mark.parametrize("capacity", [24, 9])
def test_sorted_window_puts_equal_the_reference(capacity):
    """Three sorted runs merged in turn into each rank's window (9 slots
    overflow), against the reference's window on each row."""
    rng = np.random.default_rng(capacity)
    runs = []
    for _ in range(3):
        k = np.sort(rng.choice(30, (3, 8)), axis=1).astype(np.int32)
        k[:, -2:] = SENT
        runs.append((k, rng.integers(-9, 9, (3, 8)).astype(np.int32)))
    win = windows.SortedWindow.alloc(capacity, lead=(3,))
    assert win.keys.shape == (3, capacity) and win.keys.dtype == torch.int32
    for k, v in runs:
        win = win.put(to_torch(k), to_torch(v))
    for r in range(3):
        want = jwin.SortedWindow.alloc(capacity)
        for k, v in runs:
            want = want.put(jnp.asarray(k[r]), jnp.asarray(v[r]))
        assert_equal(win.keys[r], want.keys)
        assert_equal(win.values[r], want.values)
    one = windows.SortedWindow.alloc(5, dtype=torch.int64)
    assert one.keys.shape == (5,) and one.values.dtype == torch.int64
    assert_equal(one.keys, jwin.SortedWindow.alloc(5).keys)


@pytest.mark.parametrize("W", [32, 10, 3])
def test_combine_records(W):
    V = 32
    rng = np.random.default_rng(W)
    table = np.where(rng.random((4, V)) < 0.5,
                     rng.integers(-9, 9, (4, V)), 0).astype(np.int32)
    spec = types.SimpleNamespace(combine_capacity=W, n_procs=4)
    got = windows.combine_records(to_torch(table), spec)
    want = _rows(lambda t: jwin.combine_records(t, spec), table)
    for g, w, name in zip(got, want, ("keys", "vals", "overflow")):
        assert_equal(g, w, name)
    if W < V:
        assert (got[2] > 0).any()


def test_init_carry_layout_matches_reference_segmented_carry():
    from repro.core.registry import JobSpec as JSpec
    spec = JSpec(vocab=50, task_size=8, push_cap=4, n_procs=3)
    c = windows.carry_to_numpy(windows.init_carry(spec, "cpu"))
    jc = jwin.init_carry(spec)
    for name, leaf in zip(windows.EngineCarry._fields, c):
        want = np.broadcast_to(np.asarray(getattr(jc, name)),
                               (3,) + np.shape(getattr(jc, name)))
        assert_equal(leaf, want, name)
    back = windows.carry_from_numpy(jwin.EngineCarry(*c), "cpu")
    for a, b in zip(back, c):
        assert_equal(a, b)


# ---------------------------------------------------------------------------
# collectives and the combine tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [1, 2, 5])
def test_all_to_all_and_psum_match_named_axis_collectives(P):
    x = np.random.default_rng(P).integers(-SAT, SAT, (P, P, 3)).astype(
        np.int32)
    want = jax.vmap(lambda a: jcoll.all_to_all_blocks(a, "procs"),
                    axis_name="procs")(jnp.asarray(x))
    assert_equal(coll.all_to_all_blocks(to_torch(x)), want)
    want = jax.vmap(lambda a: lax.psum(a, "procs"),
                    axis_name="procs")(jnp.asarray(x))
    assert_equal(coll.psum(to_torch(x)), want)
    assert_equal(coll.axis_index(P, "cpu"), np.arange(P))


def test_tree_gather_permute_delivers_zeros_to_non_receivers():
    x = np.arange(1, 6, dtype=np.int32)[:, None] * np.ones((1, 2), np.int32)
    got = coll.tree_gather_permute(to_torch(x), 0).numpy()
    assert got[:, 0].tolist() == [2, 0, 4, 0, 0]
    got = coll.tree_gather_permute(to_torch(x), 1).numpy()
    assert got[:, 0].tolist() == [3, 0, 0, 0, 0]
    got = coll.tree_gather_permute(to_torch(x), 2).numpy()
    assert got[:, 0].tolist() == [5, 0, 0, 0, 0]


def test_sat_add_and_sat_psum():
    a = np.array([0, 5, SAT, SAT - 3, 2**30], np.int32)
    b = np.array([0, 7, 1, 10, 2**30], np.int32)
    assert_equal(combine.sat_add_i32(to_torch(a), to_torch(b)),
                 jcombine.sat_add_i32(jnp.asarray(a), jnp.asarray(b)))
    x = np.array([SAT, 3, 2**29, 0], np.int32)
    want = jax.vmap(lambda v: jcombine._sat_psum(v, "procs", 4),
                    axis_name="procs")(jnp.asarray(x))
    assert_equal(combine._sat_psum(to_torch(x), 4), want)
    assert combine.n_levels(5) == jcombine.n_levels(5) == 3


# (3, 20): each rank fits W, but merged runs do not (loss inside the tree)
_COMBINE_CASES = [(2, 32), (3, 20), (4, 10), (5, 6), (8, 12), (8, 40)]


@pytest.fixture(scope="module")
def jax_tree_combine(devices8, tmp_path_factory):
    """The reference's combine_records + tree_combine at several P and
    W < V (with per-rank and in-tree overflow), run under shard_map in
    one 8-device subprocess."""
    out = tmp_path_factory.mktemp("combine") / "ref.npz"
    devices8(f"""
        import types
        import numpy as np, jax
        from jax.sharding import PartitionSpec as PS
        from repro.core.combine import tree_combine
        from repro.core.windows import combine_records
        from repro.distributed.collectives import shard_map
        from repro.distributed.mesh import local_mesh
        res = {{}}
        for P, W in {_COMBINE_CASES!r}:
            rng = np.random.default_rng(P * 100 + W)
            V = 40
            table = np.where(rng.random((P, V)) < 0.4,
                             rng.integers(1, 9, (P, V)), 0).astype(np.int32)
            spec = types.SimpleNamespace(combine_capacity=W, n_procs=P)
            def body(t):
                k, v, o = combine_records(t[0], spec)
                return tuple(x[None] for x in
                             tree_combine(k, v, "procs", P, o))
            fn = jax.jit(shard_map(body, mesh=local_mesh((P,), ("procs",)),
                                   in_specs=(PS("procs"),),
                                   out_specs=(PS("procs"),) * 3))
            keys, vals, total = fn(table)
            res[f"{{P}}_{{W}}_table"] = table
            res[f"{{P}}_{{W}}_keys"] = np.asarray(keys).reshape(P, -1)
            res[f"{{P}}_{{W}}_vals"] = np.asarray(vals).reshape(P, -1)
            res[f"{{P}}_{{W}}_total"] = np.asarray(total)
        np.savez({str(out)!r}, **res)
        print("OK")
    """)
    return dict(np.load(out))


@pytest.mark.parametrize("P,W", _COMBINE_CASES)
def test_tree_combine_every_rank(jax_tree_combine, P, W):
    """Every rank's output equals the reference's, not just rank 0's:
    the masked gather delivers zeros exactly as ppermute does."""
    ref = {k.split("_", 2)[2]: v for k, v in jax_tree_combine.items()
           if k.startswith(f"{P}_{W}_")}
    spec = types.SimpleNamespace(combine_capacity=W, n_procs=P)
    keys, vals, overflow = windows.combine_records(to_torch(ref["table"]),
                                                   spec)
    k, v, total = combine.tree_combine(keys, vals, P, overflow)
    assert_equal(k, ref["keys"], "keys")
    assert_equal(v, ref["vals"], "vals")
    assert_equal(total, ref["total"], "total")
    if W <= 20:
        assert int(total[0]) > 0            # these cases do overflow


# ---------------------------------------------------------------------------
# use-cases
# ---------------------------------------------------------------------------

_USECASES = [
    ("wordcount", usecases.WordCount(50), jusecases.WordCount(50)),
    ("histogram", usecases.Histogram(50, 7), jusecases.Histogram(50, 7)),
    ("inverted", usecases.InvertedIndex((3, 9, 3, 40), 4, 2),
     jusecases.InvertedIndex((3, 9, 3, 40), 4, 2)),
]


@pytest.mark.parametrize("name,uc,juc", _USECASES, ids=[u[0] for u in
                                                        _USECASES])
def test_map_emit(name, uc, juc):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 50, (4, 32)).astype(np.int32)
    tokens[rng.random((4, 32)) < 0.2] = SENT
    tid = np.array([-1, 0, 5, 11], np.int32)
    got = uc.map_emit(to_torch(tokens), to_torch(tid))
    want = _rows(juc.map_emit, tokens, tid)
    assert_equal(got[0], want[0], "keys")
    assert_equal(got[1], want[1], "values")
    assert uc.window == juc.window


def test_work_dependency_is_zero_and_map_fn_matches():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 50, (3, 16)).astype(np.int32)
    rep = np.array([1, 4, 2], np.int32)
    dep = usecase.work_dependency(to_torch(tokens), to_torch(rep), 4)
    assert dep.dtype == torch.int32 and dep.tolist() == [0, 0, 0]
    uc, juc = usecases.WordCount(50), jusecases.WordCount(50)
    got = usecase.as_map_fn(uc)(to_torch(tokens), to_torch(np.zeros(
        3, np.int32)), to_torch(rep), 4)
    want = _rows(lambda t, r: jusecase.as_map_fn(juc)(t, jnp.int32(0), r),
                 tokens, rep)
    assert_equal(got[0], want[0])
    assert_equal(got[1], want[1])


def test_oracles_equal_reference_oracles():
    tokens = np.random.default_rng(1).integers(0, 50, 999).astype(np.int32)
    tokens[::17] = SENT
    assert usecases.wordcount_oracle(tokens, 50) == \
        jusecases.wordcount_oracle(tokens, 50)
    assert_equal(usecases.histogram_oracle(tokens, 50, 7),
                 jusecases.histogram_oracle(tokens, 50, 7))
    assert json.dumps(usecases.inverted_index_oracle(
        tokens, (3, 9), 64, 2, 4), sort_keys=True) == json.dumps(
        jusecases.inverted_index_oracle(tokens, (3, 9), 64, 2, 4),
        sort_keys=True)


# ---------------------------------------------------------------------------
# numpy copies: planner, sources, imbalance grid
# ---------------------------------------------------------------------------

def test_planner_and_sources_equal_reference(tmp_path):
    data = np.random.default_rng(0).integers(0, 99, 5000).astype(np.int32)
    path = tmp_path / "tok.bin"
    data.tofile(path)
    for P, S in ((1, 64), (3, 100), (8, 37)):
        plan = planner.plan_input(len(data), S, P)
        jplan = jplanner.plan_input(len(data), S, P)
        assert (plan.n_tasks, plan.tasks_per_proc) == \
            (jplan.n_tasks, jplan.tasks_per_proc)
        ids = planner.shard_task_ids(plan)
        assert_equal(ids, jplanner.shard_task_ids(jplan))
        srcs = [(source.ArraySource(data), jsource.ArraySource(data)),
                (source.MmapTokenSource(str(path)),
                 jsource.MmapTokenSource(str(path))),
                (source.ZipfSource(5000, 99, seed=3, block=700),
                 jsource.ZipfSource(5000, 99, seed=3, block=700)),
                (source.ConcatSource([source.ArraySource(data[:1234]),
                                      source.ArraySource(data[1234:])]),
                 jsource.ConcatSource([jsource.ArraySource(data[:1234]),
                                       jsource.ArraySource(data[1234:])]))]
        for src, jsrc in srcs:
            assert_equal(planner.gather_segment(src, plan, ids),
                         jplanner.gather_segment(jsrc, jplan, ids))
            assert_equal(source.read_all(src), jsource.read_all(jsrc))


@pytest.mark.parametrize("mode", ["balanced", "unbalanced", "random"])
def test_imbalance_repeats(mode):
    assert_equal(corpus.imbalance_repeats(8, 33, mode=mode, seed=4),
                 jcorpus.imbalance_repeats(8, 33, mode=mode, seed=4))
