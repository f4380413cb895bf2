"""The smoke's guard band (``chip_smoke.banded``, phase 2e) on the CPU.

A banded copy of a tensor sits between two bands of a known pattern in
one larger allocation; a function that reads past its input changes its
output between two fills, and one that writes past its output breaks a
band. Here plain functions on CPU tensors stand in for the kernels: the
card runs the phase over every shipping kernel (``chip_smoke.py``).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from torch_parity import to_torch  # noqa: E402

CPU = torch.device("cpu")
FILLS = {torch.float32: chip_smoke.GUARD_FLOAT_FILLS,
         torch.bfloat16: chip_smoke.GUARD_FLOAT_FILLS,
         torch.int32: (0, 1)}


def _tensor(dtype, shape=(37, 5)):
    a = np.random.default_rng(len(shape)).standard_normal(shape) * 100
    return to_torch(a.astype(np.float32)).to(dtype)


def _past(t: torch.Tensor, extra: int = 1) -> torch.Tensor:
    """``t`` (contiguous) and the ``extra`` elements after it."""
    return torch.as_strided(t, (t.numel() + extra,), (1,),
                            t.storage_offset())


def _honest(x, out):
    out.copy_(x.flatten() * 2)
    return out


def _writes_past(x, out):
    _past(out)[-1] = 7
    return _honest(x, out)


def _reads_past(x, out):
    out.copy_(_past(x)[1:])
    return out


def _run(fn, x, fill: int):
    """``fn`` with its input and output banded by the ``fill``-th fill:
    its output and whether both bands held."""
    fx = FILLS[x.dtype][fill]
    xb, x_ok = chip_smoke.banded(x, fx)
    ob, o_ok = chip_smoke.banded(torch.zeros(x.numel(), dtype=x.dtype), fx)
    got = fn(xb, ob).clone()
    return got, x_ok() and o_ok()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_banded_view_equals_the_tensor_and_keeps_its_alignment(dtype):
    x = _tensor(dtype)
    for fill in FILLS[dtype]:
        v, intact = chip_smoke.banded(x, fill)
        assert torch.equal(v, x) and v.stride() == x.stride() and intact()
        base = v.untyped_storage()
        assert v.data_ptr() - base.data_ptr() == \
            chip_smoke.GUARD_BAND_BYTES and v.data_ptr() % 16 == 0
        assert base.nbytes() >= 2 * chip_smoke.GUARD_BAND_BYTES + \
            x.numel() * x.element_size()
        assert (base.nbytes() - chip_smoke.GUARD_BAND_BYTES) % 256 == 0


def test_banded_keeps_a_strided_view_and_checks_its_gaps():
    """A view with gaps (the first S positions of a longer cache): the
    skipped elements are filled as the bands are, and checked too."""
    cache = _tensor(torch.float32, (2, 10, 3, 4))
    k = cache[:, :6]
    v, intact = chip_smoke.banded(k, chip_smoke.GUARD_FLOAT_FILLS[0])
    assert torch.equal(v, k) and v.stride() == k.stride() and intact()
    gap = torch.as_strided(v, (1,), (1,), v.storage_offset() + 6 * 12)
    assert math.isnan(gap.item())
    gap.fill_(0.0)
    assert not intact()


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_band_passes_an_honest_function(dtype):
    x = _tensor(dtype)
    want = _honest(x, torch.zeros(x.numel(), dtype=dtype))
    for fill in (0, 1):
        got, intact = _run(_honest, x, fill)
        assert intact and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_band_flags_a_write_one_element_past_the_output(dtype):
    x = _tensor(dtype)
    for fill in (0, 1):
        got, intact = _run(_writes_past, x, fill)
        assert not intact
        assert torch.equal(got, _honest(x, torch.zeros_like(got)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_band_flags_a_read_one_element_past_the_input(dtype):
    """The one element read past the input is the band: the output
    changes between the two fills, though every band holds."""
    x = _tensor(dtype)
    outs = []
    for fill in (0, 1):
        got, intact = _run(_reads_past, x, fill)
        assert intact
        outs.append(got)
    assert torch.equal(outs[0][:-1], outs[1][:-1])
    assert not torch.equal(chip_smoke._bits(outs[0]),
                           chip_smoke._bits(outs[1]))
    want = to_torch(np.r_[x.flatten()[1:].numpy(),
                          np.float32(FILLS[dtype][0])]).to(dtype)
    assert torch.equal(chip_smoke._bits(outs[0]), chip_smoke._bits(want))


def test_guard_diff_holds_ints_exactly_and_floats_to_the_tolerance():
    i = torch.arange(10, dtype=torch.int32)
    assert chip_smoke.guard_diff("ints", (i,), (i.clone(),)) == 0.0
    with pytest.raises(AssertionError, match="changed"):
        chip_smoke.guard_diff("ints", (i + (i == 3),), (i,))
    f = torch.linspace(-1, 1, 10)
    assert chip_smoke.guard_diff("f32", (f + 1e-4,), (f,)) < 2e-3
    for bad in (f + 0.1, torch.where(f > 0, float("nan"), f)):
        with pytest.raises(AssertionError, match="changed"):
            chip_smoke.guard_diff("f32", (bad,), (f,))


def test_guard_fills_are_two_keys_the_kernel_counts_apart():
    call = chip_smoke.memcheck_cases(CPU)["slots_sweep2"]
    assert chip_smoke.guard_fills(*call) == (0, 63)
    assert chip_smoke.guard_fills(*chip_smoke.memcheck_cases(CPU)[
        "hist_sweep0"]) == (0, 1)


def test_guard_phase_rehearses_on_cpu():
    """Phase 2e on the CPU (the plain versions): every shipping kernel's
    cases of ``memcheck_cases``, and hist on a small stand-in for the
    full-width corpus in both modes, each run unbanded and under both
    fills; no kernel launched, no bad twin run (their plain versions
    raise on the CPU)."""
    corpus = to_torch(np.random.default_rng(0).integers(
        -5, chip_smoke.VOCAB + 5, 5000).astype(np.int32))
    got = chip_smoke.phase_guard(CPU, corpus)
    calls = chip_smoke.memcheck_cases(CPU)
    shipping = set(chip_smoke.wrappers()) - set(
        chip_smoke.MUTANT_KERNELS.values())
    assert set(got["kernels"]) == shipping
    for kernel, k in got["kernels"].items():
        n = sum(c[0] == kernel for c in calls.values())
        assert k["cases"] == n + 2 * (kernel == "hist")
        assert k["launches"] == 0 and k["max_abs_diff"] == 0.0
    assert got["bad"] == {}
