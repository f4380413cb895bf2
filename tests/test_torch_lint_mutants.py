"""fleetlint's program mutants on the port against the reference's.

* The mutant table equals ``repro.analysis.corpus.MUTANTS`` for all 20:
  name, rule, expectation and kind, in order; the program mutants'
  handles carry the reference's names, paths and replication contract.
* Each program bad twin fires its own rule, at the expected place, over
  several seeds; each near twin gives no finding at all.
* The port's findings match the reference's ``check_program`` where the
  reference's analyzer can trace: REP001's (rule, where) and the rules of
  SPMD001 and SPMD002.
* The CLI's selftest over all 20 on the CPU.
"""
import io

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import corpus as jcorpus  # noqa: E402
from repro.analysis import rules as jrules  # noqa: E402
from repro_torch.analysis import corpus, lint, rules  # noqa: E402
import torch_parity  # noqa: E402,F401  (shares the cores under xdist)

CPU = torch.device("cpu")
PROGRAMS = [m.name for m in corpus.MUTANTS if m.kind == "program"]
BAD = [n for n in PROGRAMS if n.endswith("-bad")]
NEAR = [n for n in PROGRAMS if n.endswith("-near")]
INTERFACE = ("name", "arg_paths", "out_paths", "replicated_in",
             "replicated_out", "allowed_axes")


def _mutant(mutants, name):
    return next(m for m in mutants if m.name == name)


def test_mutant_table_equals_the_reference():
    assert [(m.name, m.rule, m.fires, m.kind) for m in corpus.MUTANTS] == \
        [(m.name, m.rule, m.fires, m.kind) for m in jcorpus.MUTANTS]
    assert len(corpus.MUTANTS) == 20 and len(PROGRAMS) == 12


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_mutant_interface_equals_the_reference(name):
    port = _mutant(corpus.MUTANTS, name).build(CPU)
    ref = _mutant(jcorpus.MUTANTS, name).build()
    assert [tuple(getattr(port, f)) if f != "name" else port.name
            for f in INTERFACE] == \
        [tuple(getattr(ref, f)) if f != "name" else ref.name
         for f in INTERFACE]
    assert port.n_procs == corpus.MUTANT_PROCS != 8
    assert port.seeded == ("x0",)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", BAD)
def test_program_bad_twin_fires_its_rule(name, seed):
    mutant = _mutant(corpus.MUTANTS, name)
    got = rules.check_program(mutant.build(CPU), seed=seed)
    assert got and {f.rule for f in got} == {mutant.rule}, got
    assert all(f.program == mutant.build(CPU).name for f in got)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", NEAR)
def test_program_near_twin_gives_no_finding(name, seed):
    got = rules.check_program(_mutant(corpus.MUTANTS, name).build(CPU),
                              seed=seed)
    assert got == [], f"{name}: near miss must stay quiet, got {got}"


def test_findings_name_where_and_why():
    def run(name):
        return corpus.run_mutant(_mutant(corpus.MUTANTS, name), CPU)

    (f,) = run("spmd001-bad")
    assert "analysis/corpus.py" in f.where and "(bad)" in f.where
    assert "collective 'psum' over an operand of shape (8, 4)" in f.message
    (f,) = run("spmd002-bad")
    assert "analysis/corpus.py" in f.where and "(bad)" in f.where
    assert "collective 'psum'" in f.message and "rank-varying" in f.message
    for name in ("rep001-bad", "rep001-fold-bad", "rep001-crossjob-bad",
                 "rep001-coded-bad"):
        (f,) = run(name)
        assert f.where == "total" and "rank 1's row" in f.message, f


@pytest.mark.parametrize("name", PROGRAMS)
def test_same_findings_as_the_reference_check_program(name):
    try:
        want = jrules.check_program(_mutant(jcorpus.MUTANTS, name).build())
    except (AttributeError, TypeError) as e:
        # jax 0.9 dropped ``jax.core.ClosedJaxpr``, which the analyzer
        # reads, and refuses the spmd002 mutants' ``lax.cond`` (its
        # branches' varying manual axes differ)
        if "ClosedJaxpr" not in str(e) and "varying manual axes" not in \
                str(e):
            raise
        pytest.skip(f"the reference cannot trace under this jax: "
                    f"{str(e).splitlines()[0]}")
    got = corpus.run_mutant(_mutant(corpus.MUTANTS, name), CPU)
    # provenance differs by design for SPMD001/SPMD002: the reference
    # names the traced equation, the port the source line it ran
    assert [f.rule for f in got] == [f.rule for f in want]
    assert [(f.rule, f.where) for f in got if f.rule == "REP001"] == \
        [(f.rule, f.where) for f in want if f.rule == "REP001"]


def test_program_mutants_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        corpus.run_mutant(_mutant(corpus.MUTANTS, "rep001-near"))


def test_selftest_runs_all_twenty():
    out = io.StringIO()
    assert lint.run_selftest(CPU, True, out=out)
    lines = out.getvalue().splitlines()
    assert len(lines) == 20 and all(": ok [" in line for line in lines)
    assert [line.split()[1] for line in lines] == \
        [m.name for m in corpus.MUTANTS]
