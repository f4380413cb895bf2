"""fleetlint's program half on the port (``repro_torch.analysis``): the
shipping program matrix against the reference's.

* Handle interfaces: each of the reference's 64 handles at P = 1 (built
  in this process) and all 82 at P = 8 (built in one 8-device
  subprocess, the 18 coded handles among them) has the port's name,
  argument and output paths and replication contract.
* The shipping matrix lints clean at P = 8, one case for each backend x
  use case x variant, and the re-mesh fold.
* The rules are not vacuous on the real engine: an over-asserted finish
  handle and a ``_composite_map`` that keeps each rank's own partial
  fire REP001, a collective under a loop bounded by a rank's value fires
  SPMD002, and the steal path's read of the replicated work row is seen
  and judged replicated.
* ``collectives.ppermute`` against numpy and ``tree_gather_permute``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import corpus as jcorpus  # noqa: E402
from repro_torch.analysis import corpus, rules, spmd  # noqa: E402
from repro_torch.core import onesided  # noqa: E402
from repro_torch.core.registry import ProgramHandle  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

CPU = torch.device("cpu")
INTERFACE = ("name", "arg_paths", "out_paths", "replicated_in",
             "replicated_out", "allowed_axes")
# the port's handles, built (never run) at import: the same on every worker
P1_NAMES = [h.name for h in corpus.shipping_programs(CPU, n_procs=1)]
P8 = corpus.shipping_programs(CPU)
# one case a program triple: backend/case+variant, and the fold
TRIPLES = sorted({h.name.rsplit("/", 1)[0] for h in P8
                  if not h.name.startswith("fleet/")})


def _interface(h) -> tuple:
    return tuple(tuple(v) if isinstance(v, (tuple, list)) else v
                 for v in (getattr(h, f) for f in INTERFACE))


def _handle(name: str, handles=P8) -> ProgramHandle:
    return next(h for h in handles if h.name == name)


@pytest.fixture(scope="module")
def reference_p1():
    return {h.name: h for h in jcorpus.shipping_programs()}


@pytest.fixture(scope="module")
def reference_p8(devices8):
    out = devices8("""
        import json
        from repro.analysis import corpus
        fields = ("name", "arg_paths", "out_paths", "replicated_in",
                  "replicated_out", "allowed_axes")
        print(json.dumps([[getattr(h, f) for f in fields]
                          for h in corpus.shipping_programs()]))
    """)
    return [tuple(tuple(v) if isinstance(v, list) else v for v in row)
            for row in json.loads(out.strip().splitlines()[-1])]


# ---------------------------------------------------------------------------
# handle interfaces against the reference's
# ---------------------------------------------------------------------------

def test_p1_matrix_is_the_reference_matrix(reference_p1):
    assert P1_NAMES == list(reference_p1)
    assert len(P1_NAMES) == 64


@pytest.mark.parametrize("name", P1_NAMES)
def test_handle_interface_equals_the_reference_at_p1(name, reference_p1):
    port = corpus.shipping_programs(CPU, n_procs=1)
    assert _interface(_handle(name, port)) == _interface(reference_p1[name])


def test_p8_matrix_equals_the_reference_with_the_coded_handles(
        reference_p8):
    assert [_interface(h) for h in P8] == reference_p8
    assert len(P8) == 82
    coded = [h.name for h in P8 if "+coded" in h.name]
    assert len(coded) == 18
    assert coded[:6] == [f"1s/wordcount{v}/{k}"
                         for v in ("+coded", "+steal+coded")
                         for k in ("init", "segment", "finish")]
    assert P8[-1].name == "fleet/remesh/fold[16->8]"


def test_handles_run_at_the_lint_procs():
    assert corpus.LINT_PROCS == 8
    assert {h.n_procs for h in P8} == {8}
    segs = [h for h in P8 if h.name.endswith("/segment")]
    assert all(h.seeded == ("tokens", "task_ids", "repeats") for h in segs)
    fused = [h for h in P8 if "+fused" in h.name]
    # two fused variants a use case; segment and finish run the segments
    assert sum(h.steps for h in fused) == \
        3 * 2 * 2 * corpus.LINT_SEGMENTS * corpus.SEG_TASKS


# ---------------------------------------------------------------------------
# the shipping matrix lints clean at P = 8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("triple", TRIPLES)
def test_shipping_program_lints_clean(triple):
    for kind in ("init", "segment", "finish"):
        handle = _handle(f"{triple}/{kind}")
        assert rules.check_program(handle) == [], handle.name


def test_fold_program_lints_clean():
    (fold,) = [h for h in P8 if h.name.startswith("fleet/")]
    assert rules.check_program(fold) == []


def test_fused_finish_equals_its_unfused_twin():
    """The seeded runs give the +fused programs what they give the
    unfused ones: every finish output equal, bit for bit."""
    for case, _ in corpus.SHIPPING_CASES:
        for steal in ("", "+steal"):
            got = list(rules.run_program(
                _handle(f"1s/{case}{steal}+fused/finish"), watched=False))
            want = list(rules.run_program(
                _handle(f"1s/{case}{steal}/finish"), watched=False))
            for path, x in want[-1][1].items():
                assert_equal(got[-1][1][path], x, path)


# ---------------------------------------------------------------------------
# the rules are not vacuous on the real engine
# ---------------------------------------------------------------------------

def test_over_asserted_finish_fires_rep001():
    """Only rank 0 holds the combined records: asserting keys and values
    replicated must fire, at each of them."""
    h = _handle("1s/wordcount/finish")
    got = rules.check_program(dataclasses.replace(
        h, replicated_out=("keys", "values", "combine_overflow")))
    assert [(f.rule, f.where) for f in got] == [("REP001", "keys"),
                                                ("REP001", "values")]
    assert "rank 1's row differs from rank 0's" in got[0].message


def test_own_partial_in_job_work_fires_rep001(monkeypatch):
    """A ``_composite_map`` that adds each rank's own repeats to its own
    row of ``job_work`` (the psum dropped) fires REP001 there."""
    real = onesided._composite_map

    def dropped_psum(spec, map_fn, carry, task, task_id, rep, max_rep):
        before = carry.job_work.clone()
        out = real(spec, map_fn, carry, task, task_id, rep, max_rep)
        own = torch.zeros_like(before)
        live = task_id >= 0
        slot = torch.where(live, task_id // spec.costride, 0)
        own.scatter_add_(1, slot.long().unsqueeze(1),
                         torch.where(live, rep, 0).unsqueeze(1))
        carry.job_work.copy_(before + own)
        return out

    monkeypatch.setattr(onesided, "_composite_map", dropped_psum)
    for name in ("1s/wordcount+cosched/segment",
                 "1s/wordcount+steal+cosched/segment"):
        got = rules.check_program(_handle(name))
        assert [(f.rule, f.where) for f in got] == \
            [("REP001", "carry.job_work")], got


def _loop_program(fires: bool) -> ProgramHandle:
    def body(x):
        v = x.sum(dim=1, dtype=torch.int32)
        n = v % 3 + 1 if fires else collectives.psum(v) % 3 + 1
        for _ in range(int(n[0])):       # one rank's trip count
            v = collectives.psum(v)
        return v

    def run(seed):
        rng = np.random.default_rng(seed)
        yield body, (torch.from_numpy(
            rng.integers(0, 1000, (4, 6)).astype(np.int32)),)

    return ProgramHandle(name="loop", n_procs=4, run=run, arg_paths=("x",),
                         out_paths=("v",), seeded=("x",))


def test_collective_in_a_loop_bounded_by_a_rank_fires_spmd002():
    (f,) = rules.check_program(_loop_program(True))
    assert f.rule == "SPMD002"
    assert "test_torch_lint_programs.py" in f.where and "(body)" in f.where
    assert "collective 'psum'" in f.message
    assert rules.check_program(_loop_program(False)) == []


def test_steal_path_reads_the_replicated_work_row():
    """``SegmentFns.segment`` reads ``carry.work[0]`` to the host under
    stealing: the watch sees that read, judges it replicated and stays
    quiet, and sees the psums and exchanges of every call."""
    h = _handle("1s/wordcount+steal/segment")
    calls = list(rules.run_program(h))
    assert len(calls) == 3
    first = calls[0][2]
    assert [t for t, _ in first.reads] == [spmd.REPLICATED]
    assert "core/onesided.py" in first.reads[0][1]
    for _, _, w in calls:
        names = {c[0] for c in w.collectives}
        assert names == {"psum", "all_to_all_blocks"}
        assert w.findings == []


def test_watch_tags_rank_slices_and_propagates():
    x = torch.tensor([[1, 2], [1, 2], [3, 4]], dtype=torch.int32)
    with spmd.Watch("t", 3) as w:
        same = x[:2][0]                  # dim 0 of 2 rows: not a slice
        row = x[0]
        a, b, c = x.unbind(0)
        derived = row * 2 + 1
        y = torch.zeros(3, dtype=torch.int32)
        y.add_(x.select(0, 2)[0])
        int(derived[0])
        float(same[0])
    assert spmd.tag_of(same) is None
    assert spmd.tag_of(row) == spmd.VARYING
    assert {spmd.tag_of(t) for t in (a, b, c)} == {spmd.VARYING}
    assert spmd.tag_of(derived) == spmd.VARYING
    assert spmd.tag_of(y) == spmd.VARYING
    assert [t for t, _ in w.reads] == [spmd.VARYING]
    z = torch.ones((3, 2), dtype=torch.int32)
    with spmd.Watch("t", 3) as w:
        z[1].tolist()
    assert w.reads[0][0] == spmd.REPLICATED and w.findings == []


@pytest.mark.parametrize("index", [
    lambda r: r, lambda r: np.int64(r), lambda r: torch.tensor(r),
    lambda r: (torch.tensor(r, dtype=torch.int32), slice(None))],
    ids=["int", "numpy-int", "0-dim-tensor", "0-dim-tensor-tuple"])
def test_rank_slice_by_any_integer_index_is_tagged(index):
    """A rank's row taken with a numpy integer or a 0-dim integer tensor
    is a rank slice as a Python int's is: its host read before a psum is
    SPMD002; a bool or a 0-dim bool mask is not an index of a rank."""
    x = torch.tensor([[1, 2], [1, 2], [3, 4]], dtype=torch.int32)
    with spmd.Watch("t", 3) as w:
        row = x[index(2)]
        int(row.sum())
        collectives.psum(x)
    assert spmd.tag_of(row) == spmd.VARYING
    assert [f.rule for f in w.findings] == ["SPMD002"]
    with spmd.Watch("t", 3) as w:
        masked = x[torch.tensor(True)]
    assert spmd.tag_of(masked) is None and w.reads == []


def test_observer_slot_is_set_only_inside_a_watch():
    assert collectives.OBSERVER is None
    with spmd.Watch("t", 2):
        assert collectives.OBSERVER is not None
        with pytest.raises(RuntimeError, match="already observing"):
            spmd.Watch("u", 2).__enter__()
    assert collectives.OBSERVER is None


def test_spmd001_names_shape_and_site():
    x = torch.zeros((3, 5), dtype=torch.int32)
    with spmd.Watch("t", 3) as w:
        collectives.psum(x)
        collectives.psum(x.t())
        collectives.all_to_all_blocks(torch.zeros((3, 3, 2)))
        collectives.all_to_all_blocks(torch.zeros((2, 2, 3)))
    assert [f.rule for f in w.findings] == ["SPMD001", "SPMD001"]
    assert "shape (5, 3)" in w.findings[0].message
    assert "leading 2 dims are" in w.findings[1].message
    assert "test_torch_lint_programs.py:" in w.findings[0].where


def test_check_program_refuses_one_rank():
    h = corpus.shipping_programs(CPU, n_procs=1)[0]
    with pytest.raises(ValueError, match="P >= 2"):
        rules.check_program(h)


@pytest.mark.parametrize("fault", ["replicated", "varying", "paths"])
def test_seeded_inputs_and_interface_are_checked(fault):
    def run(seed):
        x = torch.arange(8, dtype=torch.int32).view(4, 2)
        if fault == "replicated":
            x = torch.ones((4, 2), dtype=torch.int32)
        yield collectives.psum, (x,)

    h = ProgramHandle(
        name="h", n_procs=4, run=run, arg_paths=("x",),
        out_paths=("y",) if fault != "paths" else ("y", "z"),
        replicated_in=("x",) if fault == "varying" else (),
        seeded=("x",))
    match = {"replicated": "is replicated", "varying": "is rank-varying",
             "paths": "interface out of sync"}[fault]
    with pytest.raises(ValueError, match=match):
        rules.check_program(h)


# ---------------------------------------------------------------------------
# ppermute
# ---------------------------------------------------------------------------

def _ppermute_numpy(x: np.ndarray, pairs) -> np.ndarray:
    out = np.zeros_like(x)
    for s, d in pairs:
        out[d] = x[s]
    return out


@pytest.mark.parametrize("P", [2, 5, 8])
def test_ppermute_matches_lax_semantics(P):
    rng = np.random.default_rng(P)
    x = rng.integers(-2**31, 2**31, (P, 3, 4)).astype(np.int32)
    for pairs in ([(i, (i + 1) % P) for i in range(P)],
                  [(0, P - 1)], [], [(P - 1, 0), (0, 1)]):
        got = collectives.ppermute(torch.from_numpy(x), pairs)
        assert_equal(got, _ppermute_numpy(x, pairs))
    with pytest.raises(ValueError, match="distinct destinations"):
        collectives.ppermute(torch.from_numpy(x), [(0, 1), (1, 1)])
    with pytest.raises(ValueError, match="in range"):
        collectives.ppermute(torch.from_numpy(x), [(0, P)])


@pytest.mark.parametrize("P", [2, 5, 8])
def test_ppermute_on_the_tree_pairs_is_tree_gather_permute(P):
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 100, (P, 6)).astype(np.int32))
    for level in range(3):
        s = 1 << level
        pairs = [(i + s, i) for i in range(0, P, 2 * s) if i + s < P]
        assert torch.equal(collectives.ppermute(x, pairs),
                           collectives.tree_gather_permute(x, level))
