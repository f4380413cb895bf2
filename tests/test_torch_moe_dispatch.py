"""The port's bucket slots against the JAX reference.

``repro_torch.kernels.moe_dispatch.ops.bucket_slots`` (on CPU tensors:
the plain version the CUDA kernel is held to) must equal the reference's
``bucket_slots``, whose Pallas kernel runs here in interpret mode, and
its oracle ``bucket_slots_ref``, slots and counts, on every case of the
matrix ``chip_smoke.py`` holds the kernel to on the card. Tolerance 0.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.moe_dispatch import ops as jops  # noqa: E402
from repro.kernels.moe_dispatch import ref as jref  # noqa: E402
from repro_torch.kernels.moe_dispatch import ops, ref  # noqa: E402
from torch_parity import assert_equal, to_torch  # noqa: E402

_CASES = list(chip_smoke.SLOTS_MATRIX.items())


@pytest.mark.parametrize("name,case", _CASES, ids=[c[0] for c in _CASES])
def test_bucket_slots_matches_pallas_kernel_and_oracle(name, case):
    T, E, _ = case
    ids = chip_smoke.slot_ids(case)
    slots, counts = ops.bucket_slots(to_torch(ids), E)
    assert slots.dtype == counts.dtype == torch.int32
    assert slots.shape == (T,) and counts.shape == (E,)
    for what, want in (("kernel", jops.bucket_slots(jnp.asarray(ids), E,
                                                    interpret=True)),
                       ("oracle", jref.bucket_slots_ref(jnp.asarray(ids),
                                                        E))):
        assert_equal(slots, want[0], f"{name} slots vs {what}")
        assert_equal(counts, want[1], f"{name} counts vs {what}")


def test_slots_are_ranks_in_token_order():
    """A direct count: slot[t] = #{t' < t : id[t'] == id[t]}, -1 and not
    counted for an id outside [0, E)."""
    case = chip_smoke.SLOTS_MATRIX["invalid"]
    ids = chip_smoke.slot_ids(case)
    E = case[1]
    assert {-1, E, 2**31 - 1} <= set(ids.tolist())
    slots, counts = ref.bucket_slots_ref(to_torch(ids), E)
    seen = {}
    want = []
    for i in ids.tolist():
        if 0 <= i < E:
            want.append(seen.get(i, 0))
            seen[i] = seen.get(i, 0) + 1
        else:
            want.append(-1)
    assert slots.tolist() == want
    assert counts.tolist() == [seen.get(e, 0) for e in range(E)]


def test_wrapper_policy_and_checks():
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.bucket_slots(ids, 4, use_kernel=True)
    with pytest.raises(TypeError):
        ops.bucket_slots(ids.long(), 4)
    with pytest.raises(ValueError):
        ops.bucket_slots(ids, 0)
    # the plain version takes any E; only the kernel is bounded
    slots, counts = ops.bucket_slots(ids, ops.MAX_EXPERTS + 1)
    assert slots.tolist() == list(range(8)) and int(counts.sum()) == 8
    assert_equal(ops.bucket_slots(ids[:0], 3)[1], np.zeros(3, np.int32))


def test_kernel_source_is_wired():
    src = ops.SOURCE.read_text()
    assert 'extern "C" int bucket_slots_launch(' in src
    assert "bucket_slots_pallas" in src         # names what it replaces
    assert "cudaGetLastError" in src


def test_kernel_constants_match_the_source():
    """The wrapper's threads, ids a thread and expert limit are the
    kernel's, and its epochs fit the 30 bits a status word gives them."""
    src = ops.SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kThreads"] == ops.THREADS
    assert consts["kMaxExperts"] == ops.MAX_EXPERTS
    assert [int(k) for k in re.findall(r"case (\d+): return launch<", src)] \
        == list(ops.ITEMS)
    assert ops.MAX_CALLS < 2**30 - 1


@pytest.mark.parametrize("T,sms,want", [
    (1, 132, (1, 1)),
    (98_304, 132, (1, 96)),           # the routing shape: 96 tiles of 1,024
    (135_168, 132, (1, 132)),         # one wave exactly
    (135_169, 132, (2, 67)),
    (2**20, 132, (8, 128)),           # the owner window: 128 tiles of 8,192
    (2**20 + 3, 132, (8, 129)),       # past one wave even at 8 ids a thread
    (2**22 + 3, 132, (8, 513)),
    (400_000, 132, (4, 98)),
    (2**20, 114, (8, 128)),           # a card of fewer SMs
    (500_000, 114, (8, 62)),
])
def test_plan_fills_one_wave_with_the_fewest_ids_a_thread(T, sms, want):
    assert ops.plan(T, sms) == want
    items, tiles = want
    assert tiles == -(-T // (ops.THREADS * items))


def test_scratch_is_kept_per_stream_grown_and_renewed(monkeypatch):
    """One zeroed int64 scratch per (device, stream), reused by later
    calls with no fill, grown when a call needs more, and replaced by a
    zeroed one after MAX_CALLS calls."""
    monkeypatch.setattr(ops, "_SCRATCH", {})
    monkeypatch.setattr(ops, "MAX_CALLS", 5)
    cpu = torch.device("cpu")
    a = ops._scratch(cpu, 1, 10)
    assert a.dtype == torch.int64 and a.numel() == 10
    assert int(a.abs().sum()) == 0
    a.fill_(3)                       # as a kernel would leave it
    assert ops._scratch(cpu, 1, 4) is a
    assert ops._scratch(cpu, 2, 4) is not a
    b = ops._scratch(cpu, 1, 20)
    assert b.numel() == 20 and int(b.abs().sum()) == 0
    b.fill_(3)
    for _ in range(4):
        assert ops._scratch(cpu, 1, 20) is b
    c = ops._scratch(cpu, 1, 4)
    assert c is not b and c.numel() == 20 and int(c.abs().sum()) == 0
