"""The port's LM data pipeline against the JAX package, on the CPU.

``lm_token_stream``, ``lm_batches`` (with ``skip`` and ``n_steps``), the
tokenizer and the ``DoubleBufferedLoader`` give the reference's arrays
for the same arguments and seeds: tolerance 0. ``HashTokenizer`` hashes
with Python's salted ``hash``, so it is compared within this process.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (both frameworks in one process, JAX on CPU)

from repro.data import corpus as jcorpus  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import tokenizer as jtok  # noqa: E402
from repro_torch.data import corpus as tcorpus  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.data import tokenizer as ttok  # noqa: E402
from torch_parity import assert_equal  # noqa: E402

TEXT = (b"the quick brown fox jumps over the lazy dog; the dog's day "
        b"ends, and the fox's begins. It's 2024: foxes 3, dogs 0 -- "
        b"O'Brien's quick-brown fox again")


@pytest.mark.parametrize("n,vocab,seed", [(10_000, 256, 0),
                                          (123_457, 50_304, 3),
                                          (1, 7, 1)])
def test_lm_token_stream_equals_jax(n, vocab, seed):
    got = tcorpus.lm_token_stream(n, vocab, seed=seed)
    want = jcorpus.lm_token_stream(n, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    assert_equal(got, want)


@pytest.mark.parametrize("batch,seq,skip,seed", [(4, 16, 0, 0), (3, 33, 5, 2),
                                                 (8, 64, 2, 1)])
def test_lm_batches_equal_jax_and_skip_replays(batch, seq, skip, seed):
    toks = tcorpus.lm_token_stream(5_000, 300, seed=seed)
    got = list(tpipeline.lm_batches(toks, batch, seq, n_steps=6, seed=seed,
                                    skip=skip))
    want = list(jpipeline.lm_batches(toks, batch, seq, n_steps=6, seed=seed,
                                     skip=skip))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].shape == (batch, seq) and g[k].dtype == np.int32
            assert_equal(g[k], w[k], k)
        assert_equal(g["tokens"][:, 1:], g["labels"][:, :-1])
    # skip = k replays the unskipped sequence from its k-th batch
    full = list(tpipeline.lm_batches(toks, batch, seq, n_steps=6 + skip,
                                     seed=seed))
    for g, w in zip(got, full[skip:]):
        assert_equal(g["tokens"], w["tokens"])


def test_lm_batches_pad_a_stream_shorter_than_a_batch():
    toks = np.arange(20, dtype=np.int32)
    got = next(tpipeline.lm_batches(toks, 2, 16))
    want = next(jpipeline.lm_batches(toks, 2, 16))
    for k in got:
        assert_equal(got[k], want[k], k)


def test_tokenizer_equals_jax():
    assert ttok.words_of(TEXT) == jtok.words_of(TEXT)
    counts = {}
    for w in ttok.words_of(TEXT):
        counts[w] = counts.get(w, 0) + 1
    for size in (1, 4, 100):
        tv = ttok.Vocab.from_counts(counts, size)
        jv = jtok.Vocab.from_counts(counts, size)
        assert tv.words == jv.words and tv.size == jv.size
        assert [tv.word_of(i) for i in range(tv.size)] == \
            [jv.word_of(i) for i in range(jv.size)]
        assert_equal(ttok.encode_with_vocab(TEXT, tv),
                     jtok.encode_with_vocab(TEXT, jv))
    assert ttok.UNK == jtok.UNK == 0
    for vocab in (1, 97, 50_304):       # one process: one hash salt
        assert_equal(ttok.HashTokenizer(vocab).encode(TEXT),
                     jtok.HashTokenizer(vocab).encode(TEXT))


def test_loader_on_the_cpu_hands_the_batches_through():
    """The host batches as tensors, in order, with the next one in
    flight (the host iterator is one batch ahead), then StopIteration;
    the reference's loader gives the same arrays."""
    toks = tcorpus.lm_token_stream(5_000, 300)
    pulled = []

    def host():
        for b in tpipeline.lm_batches(toks, 4, 16, n_steps=5):
            pulled.append(b)
            yield b

    loader = tpipeline.DoubleBufferedLoader(host(), torch.device("cpu"))
    assert len(pulled) == 1
    ref = jpipeline.DoubleBufferedLoader(
        jpipeline.lm_batches(toks, 4, 16, n_steps=5))
    n = 0
    for got, want in zip(loader, ref):
        n += 1
        assert len(pulled) == min(n + 1, 5)
        for k in ("tokens", "labels"):
            assert isinstance(got[k], torch.Tensor) and not got[k].is_cuda
            assert_equal(got[k], np.asarray(want[k]), k)
            assert_equal(got[k], pulled[n - 1][k], k)
    assert n == 5
    with pytest.raises(StopIteration):
        next(loader)


def test_loader_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipeline.DoubleBufferedLoader(iter([]))
