"""The port's bucket slots against the JAX reference.

``repro_torch.kernels.moe_dispatch.ops.bucket_slots`` (on CPU tensors:
the plain version the CUDA kernel is held to) must equal the reference's
``bucket_slots``, whose Pallas kernel runs here in interpret mode, and
its oracle ``bucket_slots_ref``, slots and counts, on every case of the
matrix ``chip_smoke.py`` holds the kernel to on the card. Tolerance 0.
"""
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
