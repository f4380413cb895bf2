"""The port's flash attention against the JAX package, on the CPU.

* The kernel's plain version (``kernels/flash_attention/ref.py``, the
  function the CUDA kernel is held to on the card) against the
  reference's Pallas kernel in interpret mode, over the reference's
  kernel-test matrix at that test's ``_tol`` (2e-2 bf16, 2e-3 fp32).
* The model's chunked ``flash_attention_ref`` (with its bf16 casts) and
  the dense oracle against the reference's: rtol/atol 1e-5 in fp32
  (sums in another order), 2e-2 in bf16 (a bf16 rounding of p or of the
  output may land on the other side).

Inputs are seeded numpy arrays (``chip_smoke.flash_inputs``), the same
the smoke holds the kernel to on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

CASES = chip_smoke.FLASH_MATRIX
CPU = torch.device("cpu")


def _both(name):
    """(case, torch q/k/v on the CPU, the same values as JAX arrays)."""
    case = CASES[name]
    tq = chip_smoke.flash_inputs(case, CPU)
    jq = tuple(jnp.asarray(t.float().numpy(), jnp.dtype(case[7]))
               for t in tq)
    return case, tq, jq


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_pallas_kernel(name):
    case, (q, k, v), (jq, jk, jv) = _both(name)
    causal, window, dtype = case[5:8]
    got = ref.flash_attention_plain(q, k, v, causal=causal, window=window)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                block_q=128, block_kv=128, interpret=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **chip_smoke.flash_tol(dtype))


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_reference_matches_jax(name):
    case, (q, k, v), (jq, jk, jv) = _both(name)
    causal, window, dtype = case[5:8]
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    got = tattn.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = jattn.flash_attention_ref(jq, jk, jv, causal=causal,
                                     window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    got = tattn.attention_dense_ref(q, k, v, causal=causal, window=window)
    want = jattn.attention_dense_ref(jq, jk, jv, causal=causal,
                                     window=window)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("q_offset", [0, 64])
def test_chunked_reference_small_chunks_and_offset(q_offset):
    """Several q and kv chunks, a window band and a q offset (a later
    chunk of a prefill) in fp32."""
    case, (q, k, v), (jq, jk, jv) = _both("swa128_f32")
    kw = dict(causal=True, window=96, q_chunk=128, kv_chunk=64,
              q_offset=q_offset)
    np.testing.assert_allclose(
        _np(tattn.flash_attention_ref(q, k, v, **kw)),
        _np(jattn.flash_attention_ref(jq, jk, jv, **kw)),
        rtol=1e-5, atol=1e-5)


def test_wrapper_takes_the_plain_version_on_cpu():
    case, (q, k, v), _ = _both("swa256_gqa_ragged640_bf16")
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=256)
    want = ref.flash_attention_plain(q, k, v, causal=True, window=256)
    assert torch.equal(got, want)
    assert ops.flash_attention.launches == before


def test_use_kernel_true_on_a_cpu_tensor_raises():
    _, (q, k, v), _ = _both("mha_f32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, k, v, use_kernel=True)


@pytest.mark.parametrize("bad", ["heads", "dtype", "head_dim"])
def test_wrapper_rejects_mismatched_inputs(bad):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    if bad == "heads":
        k = torch.zeros(1, 8, 3, 64)
    elif bad == "dtype":
        k = k.to(torch.bfloat16)
    else:
        k = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k)
