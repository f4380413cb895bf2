"""The port's wordcount histogram against the JAX reference.

``repro_torch.kernels.wordcount_hash.ops.wordcount_hist`` (on CPU
tensors: the plain version the CUDA kernel is held to) must equal the
reference's ``wordcount_hist``, whose Pallas kernel runs here in
interpret mode, and the port's ``wordcount_hist_ref`` the reference's
oracle ``hist_ref``, on every case of the matrix ``chip_smoke.py`` holds
the kernel to on the card. Tolerance 0 (int32 counts).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from repro.kernels.wordcount_hash import ops as jops  # noqa: E402
from repro_torch.kernels.wordcount_hash import ops, ref  # noqa: E402
from torch_parity import SENT, assert_equal, to_torch  # noqa: E402

_CASES = list(chip_smoke.HIST_MATRIX.items())


@pytest.mark.parametrize("name,case", _CASES, ids=[c[0] for c in _CASES])
def test_wordcount_hist_matches_pallas_kernel(name, case):
    _, vocab, hash_mod, _ = case
    tokens = chip_smoke.hist_tokens(case)
    got = ops.wordcount_hist(to_torch(tokens), vocab, hash_mod)
    want = jops.wordcount_hist(jnp.asarray(tokens), vocab, hash_mod,
                               interpret=True)
    assert got.dtype == torch.int32 and got.shape == (vocab,)
    assert_equal(got, want, name)


@pytest.mark.parametrize("name,case", _CASES, ids=[c[0] for c in _CASES])
def test_wordcount_hist_ref_matches_reference_oracle(name, case):
    _, vocab, hash_mod, _ = case
    tokens = chip_smoke.hist_tokens(case)
    got = ops.wordcount_hist_ref(to_torch(tokens), vocab, hash_mod)
    want = jops.wordcount_hist_ref(jnp.asarray(tokens), vocab, hash_mod)
    assert_equal(got, want, name)


def test_kernel_and_oracle_differ_only_on_negative_keys():
    """The reference's Pallas kernel drops a key outside [0, vocab); its
    oracle normalises -2 to slot vocab - 1 (and -1 to the ghost slot).
    The port keeps both behaviours, each beside its counterpart."""
    tokens = to_torch(chip_smoke.hist_tokens(chip_smoke.HIST_MATRIX[
        "out_of_range"]))
    assert ops.wordcount_hist(tokens, 8).tolist() == [0, 0, 0, 2, 0, 1, 0, 0]
    assert ops.wordcount_hist_ref(tokens, 8).tolist() == \
        [0, 0, 0, 2, 0, 1, 0, 1]
    inside = tokens[(tokens >= 0) & (tokens < 8)]
    assert_equal(ops.wordcount_hist(inside, 8),
                 ops.wordcount_hist_ref(inside, 8))


def test_owner_mode_counts_owners_of_the_port_hash():
    """Owner mode is the histogram of ``owner_of`` (mix32 % P), the
    engine's ownership rule, with SENTINELs skipped."""
    from repro_torch.core.kv import owner_of
    tokens = to_torch(chip_smoke.hist_tokens(chip_smoke.HIST_MATRIX[
        "wide_owner8"]))
    owners = owner_of(tokens[tokens != SENT], 8)
    assert_equal(ops.wordcount_hist(tokens, 8, 8),
                 torch.bincount(owners.long(), minlength=8).int())


def test_wrapper_policy_and_checks():
    tokens = torch.arange(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.wordcount_hist(tokens, 16, use_kernel=True)
    with pytest.raises(TypeError):
        ops.wordcount_hist(tokens.long(), 16)
    with pytest.raises(ValueError):
        ops.wordcount_hist(tokens, 0)
    before = ops.wordcount_hist.launches
    assert ops.wordcount_hist(tokens[:0], 4).tolist() == [0, 0, 0, 0]
    assert ops.wordcount_hist.launches == before    # the plain version
    assert_equal(ref.hist_plain(tokens, 16), np.r_[np.ones(10), np.zeros(6)])


def test_kernel_source_is_wired():
    src = ops.SOURCE.read_text()
    assert 'extern "C" int hist_launch(' in src
    assert "hist_pallas" in src                 # names what it replaces
    assert "cudaGetLastError" in src
