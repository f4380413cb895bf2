"""The port's fleetlint (``repro_torch.analysis``) against the reference's.

* The mutant kernels' plain versions against the reference's near twins,
  run in interpret mode, bit for bit on seeded numpy inputs.
* The mutant table against ``repro.analysis.corpus.MUTANTS`` (its kernel
  and ops kinds), each bad twin firing exactly its rule, each near twin
  quiet, and the same findings as the reference's ``check_kernel`` where
  the reference's analyzer can trace.
* The six shipping wrappers lint clean, every ``kernels/*/ops.py`` passes
  PAL003, and each PAL003 fault fires on its own.
* The CLI on the CPU, and the smoke's lint phase rehearsed on the CPU.
"""
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.analysis import corpus as jcorpus  # noqa: E402
from repro.analysis import rules as jrules  # noqa: E402
from repro_torch.analysis import Finding, corpus, lint, rules  # noqa: E402
from repro_torch.analysis.mutant_kernels import ops, ref  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from torch_parity import REPO, assert_equal  # noqa: E402

CPU = torch.device("cpu")
KERNEL_MUTANTS = [m.name for m in corpus.MUTANTS if m.kind == "kernel"]
NEAR = [n for n in KERNEL_MUTANTS if n.endswith("-near")]
OPS_MODULES = sorted(
    ".".join(p.relative_to(Path(REPO) / "src").with_suffix("").parts)
    for p in (Path(REPO) / "src" / "repro_torch" / "kernels").glob("*/ops.py"))


def _mutant(mutants, name):
    return next(m for m in mutants if m.name == name)


def _seeded(shapes_dtypes, seed):
    """Seeded numpy inputs: f32 standard normal; int32 over its whole
    range, so that sums wrap."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32) if dtype == np.float32
            else rng.integers(-2**31, 2**31, shape).astype(np.int32)
            for shape, dtype in shapes_dtypes]


# ---------------------------------------------------------------------------
# the near twins' plain versions against the reference's, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEAR)
def test_near_twin_plain_equals_the_reference_near_twin(name):
    jfn, jargs, _ = _mutant(jcorpus.MUTANTS, name).build().build()
    inputs = _seeded([(a.shape, np.dtype(a.dtype)) for a in jargs], 7)
    want = np.asarray(jfn(*(jnp.asarray(a) for a in inputs)))
    fn, _, kw = _mutant(corpus.MUTANTS, name).build().build(CPU)
    got = fn(*(torch.from_numpy(a) for a in inputs), **kw)
    assert_equal(got, want)


def test_table_add_adds_the_first_record_only():
    """Row 8 adds recs[0] to every entry, not the 16-int block."""
    kc = _mutant(corpus.MUTANTS, "pal001-fused-near").build()
    table, recs = (torch.from_numpy(a) for a in _seeded(
        [((512,), np.int32), ((16,), np.int32)], 3))
    got = ops.table_add(table, recs, kc.spec)
    assert torch.equal(got, table + recs[0])


def test_plain_versions_raise_where_interpret_mode_clamps():
    """The reference's bad twin, in interpret mode, clamps the block past
    the array and returns x[7] for the last row; the port's plain version
    raises instead (and the CUDA kernel would read past the array)."""
    jfn, _, _ = _mutant(jcorpus.MUTANTS, "pal001-bad").build().build()
    x = _seeded([((8, 128), np.float32)], 5)[0]
    clamped = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_array_equal(clamped[:7], x[1:])
    np.testing.assert_array_equal(clamped[7], x[7])
    for name in ("pal001-bad", "pal001-fused-bad"):
        kc = _mutant(corpus.MUTANTS, name).build()
        fn, args, kw = kc.build(CPU)
        with pytest.raises(IndexError, match=r"block index 8 on dim 0"):
            fn(*args, **kw)


# ---------------------------------------------------------------------------
# the mutant corpus
# ---------------------------------------------------------------------------

def test_mutant_table_equals_the_reference_kernel_half():
    half = ("kernel", "ops")
    want = [(m.name, m.rule, m.fires, m.kind) for m in jcorpus.MUTANTS
            if m.kind in half]
    assert [(m.name, m.rule, m.fires, m.kind) for m in corpus.MUTANTS
            if m.kind in half] == want


@pytest.mark.parametrize("name", [m.name for m in corpus.MUTANTS])
def test_mutant_corpus(name):
    mutant = _mutant(corpus.MUTANTS, name)
    got = corpus.run_mutant(mutant, CPU)
    if mutant.fires:
        assert got and {f.rule for f in got} == {mutant.rule}, got
    else:
        assert got == [], f"{name}: near miss must stay quiet, got {got}"


@pytest.mark.parametrize("name", ["pal001-bad", "pal001-fused-bad"])
def test_pal001_message_names_point_block_dim_and_range(name):
    (f,) = corpus.run_mutant(_mutant(corpus.MUTANTS, name), CPU)
    assert f.rule == "PAL001"
    for part in ("grid point (7,)", "block index 8 on dim 0",
                 "valid range [0, 8)"):
        assert part in f.message, f.message


@pytest.mark.parametrize("name", KERNEL_MUTANTS)
def test_same_findings_as_the_reference_check_kernel(name):
    try:
        want = jrules.check_kernel(_mutant(jcorpus.MUTANTS, name).build())
    except AttributeError as e:
        if "ClosedJaxpr" not in str(e):
            raise
        pytest.skip(f"the reference analyzer cannot trace under this jax: "
                    f"{e}")
    got = corpus.run_mutant(_mutant(corpus.MUTANTS, name), CPU)
    # provenance differs by design for PAL001: the reference names the
    # traced equation, the port the declared operand
    assert [(f.rule, f.program, f.message) for f in got] == \
        [(f.rule, f.program, f.message) for f in want]
    assert [f.where for f in got if f.rule == "PAL002"] == \
        [f.where for f in want if f.rule == "PAL002"]


def test_check_kernel_never_launches_a_spec_that_fails_pal001():
    calls = []

    def build(device):
        calls.append(device)
        raise AssertionError("a bad twin was launched")
    for name in ("pal001-bad", "pal001-fused-bad", "pal002-bad"):
        kc = _mutant(corpus.MUTANTS, name).build()
        got = rules.check_kernel(
            rules.KernelCheck(kc.name, build, kc.worst_count, spec=kc.spec),
            CPU)
        assert got and not calls
    near = _mutant(corpus.MUTANTS, "pal001-near").build()
    seen = []
    rules.check_kernel(rules.KernelCheck(
        near.name, lambda d: seen.append(d) or near.build(d), spec=near.spec),
        CPU)
    assert seen == [CPU]


def test_grid_points_lattice_above_4096():
    assert len(rules._grid_points((8,))) == 8
    pts = rules._grid_points((100, 100))
    assert (99, 99) in pts and (50, 0) in pts and len(pts) == 9


def test_block_map_is_affine_over_grid_axes():
    m = rules.BlockMap(scale=((2, 0), (0, 1)), shift=(1, -1))
    assert m((3, 5)) == (7, 4)


# ---------------------------------------------------------------------------
# shipping kernels and PAL003
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kname", [kc.name for kc in corpus.shipping_kernels()])
def test_shipping_kernels_clean(kname):
    kc = next(k for k in corpus.shipping_kernels() if k.name == kname)
    assert kc.spec is None
    assert rules.check_kernel(kc, CPU) == []


def test_shipping_kernels_are_the_reference_six():
    assert [kc.name for kc in corpus.shipping_kernels()] == \
        [kc.name for kc in jcorpus.shipping_kernels()]


@pytest.mark.parametrize("module", OPS_MODULES
                         + ["repro_torch.analysis.mutant_kernels.ops"])
def test_every_ops_module_passes_pal003(module):
    import importlib
    mod = importlib.import_module(module)
    assert rules.check_ops_module(mod, module) == []


def _fake_ops(**faults):
    """A wrapper module with one PAL003 fault switched on."""
    mod = types.ModuleType("fake_ops")
    mod.backend = backend
    default = faults.get("default", False)

    def plain(x):
        return x.clone()

    def launch(x):
        return x

    if faults.get("fallback"):
        def wrapper(x, *, use_kernel=default):
            if not backend.use_kernel(x, require=use_kernel):
                return plain(x)
            try:
                return launch(x)
            except RuntimeError:
                return plain(x)
    elif faults.get("own_policy"):
        def wrapper(x, *, use_kernel=default):
            if not torch.cuda.is_available():
                return plain(x)
            return launch(x)
    else:
        def wrapper(x, *, use_kernel=default):
            if not backend.use_kernel(x, require=use_kernel):
                return plain(x)
            return launch(x)
    wrapper.__module__ = mod.__name__
    mod.wrapper = wrapper
    if faults.get("private"):
        mod._on_gpu = lambda: False
    if faults.get("no_backend"):
        del mod.backend
    return mod


@pytest.mark.parametrize("fault,needle", [
    ({}, None),
    ({"private": True}, "private _on_gpu"),
    ({"default": None}, "defaults use_kernel=None"),
    ({"own_policy": True}, "torch.cuda.is_available"),
    ({"fallback": True}, "falls back to the plain version (plain)"),
    ({"no_backend": True}, "does not use the shared"),
])
def test_pal003_fires_on_each_fault(fault, needle):
    got = rules.check_ops_module(_fake_ops(**fault), "fake")
    if needle is None:
        assert got == []
    else:
        assert got and all(f.rule == "PAL003" for f in got)
        assert any(needle in f.message for f in got), got


# ---------------------------------------------------------------------------
# the mutant wrappers
# ---------------------------------------------------------------------------

def test_mutant_wrappers_take_the_plain_version_on_cpu():
    before = (ops.copy_rows.launches, ops.table_add.launches,
              ops.copy_rows_i32.launches)
    for name in NEAR:
        fn, args, kw = _mutant(corpus.MUTANTS, name).build().build(CPU)
        fn(*args, **kw)
        with pytest.raises(ValueError, match="use_kernel=True"):
            fn(*args, **kw, use_kernel=True)
    assert (ops.copy_rows.launches, ops.table_add.launches,
            ops.copy_rows_i32.launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "rank"])
def test_mutant_wrappers_check_tensors_against_the_spec(bad):
    spec = _mutant(corpus.MUTANTS, "pal001-near").build().spec
    x = {"shape": torch.zeros((8, 64)),
         "dtype": torch.zeros((8, 128), dtype=torch.int32),
         "rank": torch.zeros((1024,))}[bad]
    with pytest.raises((ValueError, TypeError)):
        ops.copy_rows(x, spec)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_selftest_passes(capsys):
    assert lint.main(["--selftest", "--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_kernels_clean_json(capsys):
    assert lint.main(["--kernels", "--json", "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["checked"] == {"kernels": 6}
    assert payload["findings"] == []


def test_cli_all_clean_json(capsys):
    assert lint.main(["--all", "--json", "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["checked"] == {"programs": 82, "kernels": 6}
    assert payload["findings"] == [] and payload["waived"] == []


def test_cli_default_checks_programs_and_kernels(capsys):
    assert lint.main(["--programs", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == \
        "fleetlint: 82 programs checked — clean"
    assert lint.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == \
        "fleetlint: 82 programs, 6 kernels checked — clean"


def test_cli_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main(["--selftest"])


@pytest.mark.parametrize("name", ["pal001-near", "pal002-near",
                                  "pal003-near"])
def test_analysis_functions_default_to_the_card(monkeypatch, name):
    """With no device given, ``check_kernel`` and ``run_mutant`` resolve
    the card, as every entry point does: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mutant = _mutant(corpus.MUTANTS, name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        corpus.run_mutant(mutant)
    if mutant.kind == "kernel":
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rules.check_kernel(mutant.build())


def test_cli_waiver_matching():
    f = Finding("PAL002", "moe_dispatch", "output 0", "msg")
    assert lint._is_waived(f, [("PAL002", "moe")])
    assert lint._is_waived(f, [("PAL002", "output 0")])
    assert not lint._is_waived(f, [("PAL001", "moe")])
    assert not lint._is_waived(f, [("PAL002", "flash")])
    with pytest.raises(SystemExit):
        lint._parse_waivers(["PAL002"])


def test_finding_matches_the_reference_form():
    from repro.analysis.taint import Finding as JFinding
    args = ("PAL001", "p", "w", "m")
    assert str(Finding(*args)) == str(JFinding(*args))
    assert Finding(*args).to_json() == JFinding(*args).to_json()


# ---------------------------------------------------------------------------
# the smoke's lint and memcheck phases, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_smoke_lint_phase_rehearses_on_cpu():
    """The lint phase on the CPU: programs and kernels clean and PASS, no
    kernel launched, the +fused handles' steps counted, each +fused
    finish equal to its unfused twin's and each near twin's wrapper to
    its plain version; the bounds count each operand once (of recs, the
    one entry read)."""
    got = chip_smoke.phase_lint(CPU)
    assert got["launches"] == {"fused_map": 0, "copy_rows": 0,
                               "table_add": 0, "copy_rows_i32": 0}
    assert got["fused_steps"] == 72
    assert got["fused_twins"] == [
        f"1s/{case}{v}+fused/finish" for case in ("wordcount", "histogram",
                                                 "invindex")
        for v in ("", "+steal")]
    assert got["seconds"] > 0
    assert got["max_abs_err"] == {n: 0 for n in chip_smoke.MUTANT_KERNELS}
    cases = got["cases"]
    assert cases["pal001-near"]["bound"][2]["bytes"] == 2 * 8 * 128 * 4
    assert cases["pal001-fused-near"]["bound"][2]["bytes"] == 2 * 512 * 4 + 4
    assert all(c["bound"][1] == "bytes" for c in cases.values())
    c = cases["pal001-fused-near"]
    assert torch.equal(c["run"](), c["library"]())


def test_smoke_memcheck_cases_cover_every_kernel():
    """What memcheck (a) runs: every kernel of the kernels line, no
    full-width shape, and each case runs (the plain versions here)."""
    calls = chip_smoke.memcheck_cases(CPU)
    kernels = {k for k, _ in calls.values()}
    assert kernels == set(chip_smoke.wrappers())
    assert "fused_full_width" not in calls
    assert {f"flash_{n}" for n in chip_smoke.FLASH_MATRIX} <= set(calls)
    for name in ("pal001-near", "pal001-fused-near", "pal002-near"):
        calls[name][1]()
    assert set(chip_smoke.PAL001_BAD) == {
        m.name for m in corpus.MUTANTS if m.fires and m.rule == "PAL001"}


def test_smoke_child_mode_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main(["--memcheck-child", "shipping"]) != 0
    assert capsys.readouterr().out == ""
