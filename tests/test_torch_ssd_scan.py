"""The port's SSD scan against the JAX package, on the CPU.

* The kernel's wrapper on CPU tensors (its plain version,
  ``kernels/ssd_scan/ref.py::ssd_plain``, the function the CUDA kernel is
  held to on the card) against the reference's Pallas kernel in
  interpret mode, over ``chip_smoke.SSD_MATRIX`` (the reference's sweep,
  a ragged S and two groups) at the reference test's ``_tol`` (2e-2
  bf16, 2e-3 fp32), and with a carried-in ``init_state``.
* The model's ``ssd_ref`` (x·dt rounding in the input dtype),
  ``ssd_decode_step``, ``_causal_conv`` and the activations against the
  reference's: rtol/atol 1e-5 in fp32 (sums in another order), 1e-2 in
  bf16 (one bf16 rounding of y may land on the other side). For
  ``ssd_ref`` the atol is that fraction of max|ref|: its sums run over
  up to 512 rows to values above 100.
* A case whose exp(cum_i - cum_j) overflows above the diagonal stays
  finite, and ``ssd_bound`` counts the served shape's bytes and FLOPs.
* ``ref.ssd_chunked_plain``, the bf16 kernel's three passes (each
  chunk's state from zero, the chain of entering states, the outputs) in
  torch, against the Pallas kernel and ``ssd_plain`` over the matrix and
  S = 1 and 37 in fp32, y and final state at ``_tol``; and the premise of
  the card's bits check (``chip_smoke.check_ssd_bits``): fp32 sums in
  another order move few of y's bf16 bits, scores rounded to bf16 many.

Inputs are seeded numpy arrays (``chip_smoke.ssd_inputs``), the same
the smoke holds the kernel to on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.ssd_scan import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssd_scan import ops, ref  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

CASES = chip_smoke.SSD_MATRIX
CPU = torch.device("cpu")
# the chunked plain version's extra cases: one row, and S below a chunk
CHUNKED_CASES = {
    **CASES,
    "s1_f32": (1, 1, 2, 32, 16, 1, 64, "float32", "float32", None),
    "s37_f32": (2, 37, 4, 64, 32, 2, 64, "float32", "float32", None),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax(ts):
    return tuple(jnp.asarray(t.float().numpy(), jnp.dtype(str(t.dtype)[6:]))
                 for t in ts)


def _both(case):
    t = chip_smoke.ssd_inputs(case, CPU)
    return t, _jax(t)


def _model_tol(dtype):
    return (dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel(name):
    case = CASES[name]
    (x, dt, A, B, C), j = _both(case)
    chunk, dtype = case[6], case[7]
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    jy, jst = jops.ssd(*j, chunk=chunk, interpret=True)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (
        x.shape[0], x.shape[2], x.shape[3], B.shape[3])
    tol = chip_smoke.flash_tol(dtype)
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    np.testing.assert_allclose(_np(st), _np(jst), **tol)


@pytest.mark.parametrize("name", list(CHUNKED_CASES))
def test_chunked_plain_matches_pallas_kernel_and_plain(name):
    case = CHUNKED_CASES[name]
    (x, dt, A, B, C), j = _both(case)
    chunk, dtype = case[6], case[7]
    y, st = ref.ssd_chunked_plain(x, dt, A, B, C, chunk=chunk)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert st.dtype == torch.float32 and st.shape == (
        x.shape[0], x.shape[2], x.shape[3], B.shape[3])
    jy, jst = jops.ssd(*j, chunk=chunk, interpret=True)
    py, pst = ref.ssd_plain(x, dt, A, B, C, chunk=chunk)
    tol = chip_smoke.flash_tol(dtype)
    for want_y, want_st in ((jy, jst), (py, pst)):
        np.testing.assert_allclose(_np(y), _np(want_y), **tol)
        np.testing.assert_allclose(_np(st), _np(want_st), **tol)


@pytest.mark.parametrize("name", ["sweep3_bf16", "g4_bf16"])
def test_bf16_scores_move_more_bits_than_reordered_sums(name):
    """What ``check_ssd_bits`` holds the card to: against ``ssd_plain``'s
    bf16 y, the chunked passes (the same fp32 function, summed in another
    order) differ in under a quarter of the share that the control, with
    its decayed scores rounded to bf16, differs in."""
    case = CASES[name]
    args, _ = _both(case)
    want = ref.ssd_plain(*args, chunk=case[6])[0]
    chunked = ref.ssd_chunked_plain(*args, chunk=case[6])[0]
    control = chip_smoke._plain_scores_bf16(*args, case[6])
    reordered = (chunked != want).float().mean().item()
    rounded = (control != want).float().mean().item()
    assert rounded > 0.1
    assert reordered < rounded / 4


def test_wrapper_picks_the_source_by_dtype():
    assert ops.SOURCES[torch.bfloat16].name == "ssd_scan_bf16.cu"
    assert ops.SOURCES[torch.float32].name == "ssd_scan.cu"
    assert all(p.exists() for p in ops.SOURCES.values())
    assert ops.DEVICE_KERNELS == {torch.bfloat16: 3, torch.float32: 1}


def test_init_state_matches_reference():
    """The reference test's streaming setup (B 1, S 256, H 2, P 32, N 16,
    chunk 64): the second half from the first half's state equals the
    Pallas wrapper's closed form and the scan of the whole sequence."""
    case = (1, 256, 2, 32, 16, 1, 64, "float32", "float32", None)
    (x, dt, A, B, C), (jx, jdt, jA, jB, jC) = _both(case)
    h = 128
    y_full, st_full = ops.ssd(x, dt, A, B, C, chunk=64)
    _, st1 = ops.ssd(x[:, :h], dt[:, :h], A, B[:, :h], C[:, :h], chunk=64)
    y2, st2 = ops.ssd(x[:, h:], dt[:, h:], A, B[:, h:], C[:, h:], chunk=64,
                      init_state=st1)
    _, jst1 = jops.ssd(jx[:, :h], jdt[:, :h], jA, jB[:, :h], jC[:, :h],
                       chunk=64, interpret=True)
    jy2, jst2 = jops.ssd(jx[:, h:], jdt[:, h:], jA, jB[:, h:], jC[:, h:],
                         chunk=64, init_state=jst1, interpret=True)
    tol = chip_smoke.flash_tol("float32")
    np.testing.assert_allclose(_np(y2), _np(jy2), **tol)
    np.testing.assert_allclose(_np(st2), _np(jst2), **tol)
    np.testing.assert_allclose(_np(y2), _np(y_full[:, h:]), **tol)
    np.testing.assert_allclose(_np(st2), _np(st_full), **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_model_ssd_ref_matches_jax(name):
    case = CASES[name]
    (x, dt, A, B, C), j = _both(case)
    chunk, dtype = case[6], case[7]
    init = np.random.default_rng(5).standard_normal(
        (x.shape[0], x.shape[2], x.shape[3], B.shape[3]), np.float32)
    got = tssm.ssd_ref(x, dt, A, B, C, chunk=chunk,
                       init_state=torch.from_numpy(init))
    want = jssm.ssd_ref(*j, chunk=chunk, init_state=jnp.asarray(init))
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        tol = _model_tol(dtype)
        tol["atol"] *= float(np.abs(_np(w)).max())
        np.testing.assert_allclose(_np(g), _np(w), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(7)
    Bb, H, P, N, G = 2, 8, 16, 16, 2
    arrays = {
        "state": rng.standard_normal((Bb, H, P, N), np.float32),
        "x_t": rng.standard_normal((Bb, H, P), np.float32),
        "dt_t": np.logaddexp(rng.standard_normal((Bb, H), np.float32), 0),
        "A": -np.exp(rng.standard_normal((H,), np.float32)),
        "B_t": rng.standard_normal((Bb, G, N), np.float32),
        "C_t": rng.standard_normal((Bb, G, N), np.float32),
    }
    types = {k: ("float32" if k in ("state", "A") else dtype) for k in arrays}
    t = {k: torch.from_numpy(a).to(getattr(torch, types[k]))
         for k, a in arrays.items()}
    j = {k: jnp.asarray(a, jnp.dtype(types[k])) for k, a in arrays.items()}
    y, st = tssm.ssd_decode_step(**t)
    jy, jst = jssm.ssd_decode_step(**j)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(jy), **_model_tol(dtype))
    np.testing.assert_allclose(_np(st), _np(jst), **_model_tol(dtype))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype, carry):
    rng = np.random.default_rng(8)
    u = rng.standard_normal((2, 24, 40), np.float32)
    w = rng.standard_normal((4, 40), np.float32) * 0.5
    c = rng.standard_normal((2, 3, 40), np.float32) if carry else None
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    out, new = tssm._causal_conv(
        torch.from_numpy(u).to(tdt), torch.from_numpy(w).to(tdt),
        None if c is None else torch.from_numpy(c).to(tdt))
    jout, jnew = jssm._causal_conv(
        jnp.asarray(u, jdt), jnp.asarray(w, jdt),
        None if c is None else jnp.asarray(c, jdt))
    assert out.dtype == tdt and new.shape == (2, 3, 40)
    np.testing.assert_allclose(_np(out), _np(jout), **_model_tol(dtype))
    np.testing.assert_array_equal(_np(new), _np(jnew))   # a copy of inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_match_jax(dtype):
    """softplus and silu round as the reference's do; no cut-over at 20."""
    x = np.concatenate([np.random.default_rng(9).standard_normal(4096) * 6,
                        [-90.0, -30.0, 19.0, 21.0, 40.0, 90.0]]).astype(
        np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    for mine, theirs in ((tssm.softplus, jax.nn.softplus),
                         (tssm.silu, jax.nn.silu)):
        np.testing.assert_allclose(_np(mine(tx)), _np(theirs(jx)),
                                   **_model_tol(dtype))


def test_overflowing_decay_stays_finite():
    """The matrix's overflow case: exp(cum_i - cum_j) is inf above the
    diagonal, and every output is finite and agrees with the Pallas
    kernel and the model's ``ssd_ref``."""
    (x, dt, A, B, C), j = _both(CASES["overflow_f32"])
    cum = torch.cumsum(dt[0, :64, 0] * A[0], 0)
    assert torch.isinf(torch.exp(cum[0] - cum[-1]))
    y, st = ops.ssd(x, dt, A, B, C, chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    jy, jst = jops.ssd(*j, chunk=64, interpret=True)
    tol = chip_smoke.flash_tol("float32")
    np.testing.assert_allclose(_np(y), _np(jy), **tol)
    np.testing.assert_allclose(_np(st), _np(jst), **tol)
    ry, rst = tssm.ssd_ref(x, dt, A, B, C, chunk=64)
    np.testing.assert_allclose(_np(y), _np(ry), **tol)
    np.testing.assert_allclose(_np(st), _np(rst), **tol)


def test_ssd_bound_counts_the_shapes():
    t, by, work = chip_smoke.ssd_bound(chip_smoke.SSD_SERVED)
    x_bytes = 8 * 2048 * 48 * 64 * 2
    assert work["bytes"] == (2 * x_bytes + 8 * 2048 * 48 * 2 + 48 * 4
                             + 2 * 8 * 2048 * 128 * 2 + 8 * 48 * 64 * 128 * 4)
    pairs = 8 * (256 * 257 // 2) * 2 * (128 + 64)
    state = 2 * 64 * 128 * (2048 - 256) + 2 * 64 * 128 * 2048
    assert work["flops"] == 8 * 48 * (pairs + state)
    assert by == "bytes" and abs(t - work["bytes"] / 3.35e12 * 1e3) < 1e-12
    assert 0.066 < t < 0.068
    _, _, ragged = chip_smoke.ssd_bound(CASES["ragged200_f32"])
    per_head = ((3 * 64 * 65 // 2 + 8 * 9 // 2) * 2 * (16 + 32)
                + 2 * 32 * 16 * (200 - 64) + 2 * 32 * 16 * 200)
    assert ragged["flops"] == 1 * 4 * per_head


def test_wrapper_takes_the_plain_version_on_cpu():
    case = CASES["g2_ragged320_bf16"]
    (x, dt, A, B, C), _ = _both(case)
    before = ops.ssd.launches
    got = ops.ssd(x, dt, A, B, C, chunk=case[6])
    want = ref.ssd_plain(x, dt, A, B, C, chunk=case[6])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.ssd.launches == before


def test_use_kernel_true_on_a_cpu_tensor_raises():
    (x, dt, A, B, C), _ = _both(CASES["sweep1_f32"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ssd(x, dt, A, B, C, chunk=64, use_kernel=True)


@pytest.mark.parametrize("bad", ["groups", "dt_shape", "B_dtype", "A_dtype"])
def test_wrapper_rejects_mismatched_inputs(bad):
    x = torch.zeros(1, 8, 4, 32)
    dt = torch.zeros(1, 8, 4)
    A = torch.zeros(4)
    B = torch.zeros(1, 8, 1, 16)
    if bad == "groups":
        B = torch.zeros(1, 8, 3, 16)
    elif bad == "dt_shape":
        dt = torch.zeros(1, 8, 2)
    elif bad == "B_dtype":
        B = B.to(torch.bfloat16)
    else:
        A = A.double()
    with pytest.raises((ValueError, TypeError)):
        ops.ssd(x, dt, A, B, B if bad != "B_dtype" else B.float())
