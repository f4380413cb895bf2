"""The port's flash_decode against the JAX reference.

``repro_torch.kernels.flash_decode.ops.flash_decode`` (on CPU tensors:
the plain version the CUDA kernel is held to) must agree with the
reference's ``flash_decode``, whose Pallas kernel runs here in interpret
mode, and with its oracle ``flash_decode_ref``, at the reference's
per-dtype tolerance (``tests/test_kernels.py::_tol``), on every case of
the matrix ``chip_smoke.py`` holds the kernel to on the card. The port's
own ``flash_decode_ref`` is held to the reference's oracle likewise.
Inputs are made in fp32 with numpy and cast to the case's dtype on both
sides, which rounds them alike.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.flash_decode import ops as jops  # noqa: E402
from repro.kernels.flash_decode import ref as jref  # noqa: E402
from repro_torch.kernels.flash_decode import ops, ref  # noqa: E402

_CASES = list(chip_smoke.DECODE_MATRIX.items())


def _inputs(case):
    """(torch q, k, v), (jax q, k, v) of one case from the same bits."""
    tq = chip_smoke.decode_inputs(case, torch.device("cpu"))
    jdt = getattr(jnp, case[6])
    jq = tuple(jnp.asarray(x.float().numpy()).astype(jdt) for x in tq)
    return tq, jq


def _close(got, want, dtype, msg):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **chip_smoke.flash_tol(dtype))


@pytest.mark.parametrize("name,case", _CASES, ids=[c[0] for c in _CASES])
def test_flash_decode_matches_pallas_kernel_and_oracle(name, case):
    (q, k, v), (jq, jk, jv) = _inputs(case)
    t, dtype = case[5], case[6]
    got = ops.flash_decode(q, k, v, torch.tensor(t, dtype=torch.int32))
    assert got.shape == q.shape and got.dtype == q.dtype
    assert bool(torch.isfinite(got).all())
    # block_kv 128 divides every case's S (the reference's tests use 128)
    _close(got, jops.flash_decode(jq, jk, jv, jnp.int32(t), block_kv=128,
                                  interpret=True), dtype, f"{name} kernel")
    _close(got, jref.flash_decode_ref(jq, jk, jv, jnp.int32(t)), dtype,
           f"{name} oracle")
    _close(ref.flash_decode_ref(q, k, v, t),
           jref.flash_decode_ref(jq, jk, jv, jnp.int32(t)), dtype,
           f"{name} port oracle")


def test_flash_decode_masks_future_slots():
    """tests/test_kernels.py::test_flash_decode_masks_future_slots: entries
    at positions >= t do not contribute."""
    case = chip_smoke.DECODE_MATRIX["future_hd32_f32"]
    (q, k, v), _ = _inputs(case)
    t = case[5]
    out1 = ops.flash_decode(q, k, v, t)
    k2, v2 = k.clone(), v.clone()
    k2[:, t:], v2[:, t:] = 999.0, -999.0
    np.testing.assert_allclose(ops.flash_decode(q, k2, v2, t).numpy(),
                               out1.numpy(), atol=1e-5)


def test_edges_of_t():
    """t = 0 gives zeros, not NaN; t past S reads the whole cache, as t = S
    does; a tensor t and an int t agree."""
    case = chip_smoke.DECODE_MATRIX["tS_f32"]
    (q, k, v), _ = _inputs(case)
    S = k.shape[1]
    assert ops.flash_decode(q, k, v, 0).abs().max().item() == 0.0
    full = ops.flash_decode(q, k, v, S)
    assert torch.equal(ops.flash_decode(q, k, v, S + 5), full)
    assert torch.equal(ops.flash_decode(
        q, k, v, torch.tensor(S + 5, dtype=torch.int32)), full)


def test_no_padding_where_the_reference_kernel_counts_it():
    """The reference's wrapper pads k and v to a multiple of block_kv and
    masks only positions >= t, so at t > S with S not a multiple of
    block_kv its kernel lets zero keys into the softmax and leaves its
    own oracle. The port has no padding and stays on the oracle."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((1, 2, 32), (1, 300, 2, 32), (1, 300, 2, 32)))
    want = np.asarray(jref.flash_decode_ref(q, k, v, jnp.int32(305)))
    pallas = np.asarray(jops.flash_decode(q, k, v, jnp.int32(305),
                                          block_kv=128, interpret=True))
    assert np.abs(pallas - want).max() > 2e-3          # the padding counts
    got = ops.flash_decode(*(torch.from_numpy(x) for x in (q, k, v)), 305)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_grouped_query_heads_read_their_kv_head():
    """Query head h reads KV head h // G: at G = 4, hd = 80 each head's
    output equals single-head decode against its KV head alone."""
    case = chip_smoke.DECODE_MATRIX["g4_hd80_f32"]
    (q, k, v), _ = _inputs(case)
    t = case[5]
    got = ops.flash_decode(q, k, v, t)
    G = q.shape[1] // k.shape[2]
    for h in range(q.shape[1]):
        one = ops.flash_decode(q[:, h:h + 1], k[:, :, h // G:h // G + 1],
                               v[:, :, h // G:h // G + 1], t)
        np.testing.assert_allclose(got[:, h].numpy(), one[:, 0].numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bad", ["use_kernel", "dtype", "mixed", "shape",
                                 "t"])
def test_wrapper_policy_and_checks(bad):
    q = torch.zeros(1, 4, 64)
    k = torch.zeros(1, 16, 2, 64)
    t = 3
    kw = {}
    if bad == "use_kernel":
        kw["use_kernel"] = True
    elif bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "mixed":
        q = q.bfloat16()
    elif bad == "shape":
        k = torch.zeros(1, 16, 3, 64)
    else:
        t = torch.tensor([3], dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_decode(q, k, k, t, **kw)


def test_split_plan_covers_the_cache_in_whole_tiles():
    for B, S, KV, block_kv, sms in [(8, 2080, 16, 1024, 132),
                                    (8, 2080, 8, 1024, 114),
                                    (1, 256, 2, 128, 132),
                                    (1, 64, 1, 1024, 132),
                                    (64, 100000, 8, 1024, 132)]:
        splits, chunk = ops.split_plan(B, S, KV, block_kv, sms)
        assert chunk % ops.TILE == 0
        assert (splits - 1) * chunk < S <= splits * chunk
    # olmo-1b's cache on an H100 SXM's 132 SMs, and on a card of 114
    assert ops.split_plan(8, 2080, 16, 1024, 132) == (5, 448)
    assert ops.split_plan(8, 2080, 16, 1024, 114) == (4, 576)
    # h2o-danube-1.8b's
    assert ops.split_plan(8, 2080, 8, 1024, 132) == (9, 256)
    assert ops.split_plan(8, 2080, 8, 1024, 114) == (7, 320)


def test_block_kv_bounds_the_keys_of_a_split():
    """``block_kv`` is the most keys a split reads: below what filling the
    card gives, it raises the split count; above, it changes nothing."""
    assert ops.split_plan(8, 2080, 16, 64, 132) == (33, 64)
    assert ops.split_plan(8, 2080, 16, 256, 132) == (9, 256)
    assert ops.split_plan(8, 2080, 16, 4096, 132) == (5, 448)


def test_kernel_source_and_bound_are_wired():
    src = ops.SOURCE.read_text()
    assert 'extern "C" int flash_decode_launch(' in src
    assert "flash_decode_pallas" in src         # names what it replaces
    bound_ms, by, work = chip_smoke.decode_bound(
        chip_smoke.DECODE_FULL["olmo-1b"])
    assert by == "bytes"
    assert work["bytes"] == (2 * 8 * 16 * 128 + 2 * 8 * 2079 * 16 * 128) * 2
