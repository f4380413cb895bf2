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
    # block_kv 128 as in the reference's tests; where it does not divide S
    # (S 96, 192, 300, 1500), the reference's kernel pads the cache, and it
    # masks that padding only below t (ROADMAP Queue 3): every such case
    # has t < S
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


def _waves(B, S, KV, block_kv, sms, ctas):
    """The fewest waves of CTAs a plan within ``block_kv`` can take."""
    tiles = -(-S // ops.TILE)
    least = -(-tiles // max(1, block_kv // ops.TILE))
    return -(-B * KV * least // (sms * ctas))


def test_split_plan_covers_the_cache_in_whole_tiles():
    """The splits cover the cache in whole tiles, and their B*KV*splits
    CTAs fill the fewest waves they can take, with no partial wave past
    them: one more split a head would start another wave."""
    for B, S, KV, block_kv, sms, ctas in [
            (8, 2080, 16, 1024, 132, 3), (8, 2080, 8, 1024, 132, 4),
            (8, 2080, 16, 1024, 114, 3), (8, 2080, 8, 1024, 114, 4),
            (1, 256, 2, 128, 132, 3), (1, 64, 1, 1024, 132, 2),
            (64, 100000, 8, 1024, 132, 3), (3, 1000, 5, 100, 7, 1)]:
        splits, chunk = ops.split_plan(B, S, KV, block_kv, sms, ctas)
        tiles = -(-S // ops.TILE)
        assert chunk % ops.TILE == 0
        assert (splits - 1) * chunk < S <= splits * chunk
        slots, waves = sms * ctas, _waves(B, S, KV, block_kv, sms, ctas)
        assert B * KV * splits <= waves * slots
        assert splits == tiles or B * KV * (splits + 1) > waves * slots
    # olmo-1b's and h2o-danube-1.8b's served caches (B 8, S 2080, bf16):
    # one wave on an H100 SXM's 132 SMs at 3 and 4 CTAs an SM, and two
    # nearly full waves on a card of 114 SMs at 3
    for KV, ctas, want in [(16, 3, (3, 704)), (8, 3, (6, 352)),
                           (16, 4, (4, 544)), (8, 4, (8, 288))]:
        assert ops.split_plan(8, 2080, KV, 1024, 132, ctas) == want
        assert 8 * KV * want[0] <= 132 * ctas
    assert ops.split_plan(8, 2080, 16, 1024, 114, 3) == (5, 416)
    assert ops.split_plan(8, 2080, 8, 1024, 114, 3) == (5, 416)


def test_block_kv_bounds_the_keys_of_a_split():
    """``block_kv`` is the most keys a split reads (whole tiles, at least
    one): below what filling the card gives, it raises the split count;
    above, it changes nothing."""
    for block_kv in (1, 31, 32, 64, 100, 256, 1024, 4096):
        _, chunk = ops.split_plan(8, 2080, 16, block_kv, 132, 3)
        assert chunk <= max(block_kv, ops.TILE)
    assert ops.split_plan(8, 2080, 16, 64, 132, 3) == (33, 64)
    assert ops.split_plan(8, 2080, 16, 256, 132, 3) == (9, 256)
    assert ops.split_plan(8, 2080, 16, 4096, 132, 3) == (3, 704)


def test_decode_timing_takes_turns():
    """``chip_smoke._in_turns`` measures each function forward and then
    backward (a, b, c, c, b, a) and averages the two readings."""
    order = []

    def measure(name):
        order.append(name)
        return float(len(order))

    got = chip_smoke._in_turns({n: n for n in "abc"}, measure)
    assert order == list("abccba")
    assert got == {"a": 3.5, "b": 3.5, "c": 3.5}


def test_kernel_source_and_bound_are_wired():
    src = ops.SOURCE.read_text()
    assert 'extern "C" int flash_decode_launch(' in src
    assert 'extern "C" int flash_decode_ctas_per_sm(' in src
    assert "flash_decode_pallas" in src         # names what it replaces
    assert "What bounds it" in src and "mbarrier" in src
    bound_ms, by, work = chip_smoke.decode_bound(
        chip_smoke.DECODE_FULL["olmo-1b"])
    assert by == "bytes"
    assert work["bytes"] == (2 * 8 * 16 * 128 + 2 * 8 * 2079 * 16 * 128) * 2
