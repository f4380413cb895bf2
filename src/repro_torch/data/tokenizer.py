"""Host-side tokenizer: where variable-length keys live (counterpart of
``repro/data/tokenizer.py``).

The paper encodes variable-length ``<h|key|value>`` records on the wire;
the device engine wants fixed-width lanes. This module turns byte
strings into dense int32 ids on the host, and everything on the device
is fixed-width. ``Vocab`` can be built by the MapReduce engine itself
(a WordCount over a corpus, its top-k words).

``HashTokenizer`` maps a word through Python's built-in ``hash``, which
is salted per process (``PYTHONHASHSEED``): its ids equal the
reference's only within one process.
"""
from __future__ import annotations

import re
from collections.abc import Iterable
from dataclasses import dataclass, field

import numpy as np

_WORD = re.compile(rb"[A-Za-z0-9']+")

UNK = 0


def words_of(data: bytes) -> list[bytes]:
    return _WORD.findall(data)


@dataclass
class Vocab:
    """word <-> id mapping. id 0 is <unk>."""
    words: list[bytes] = field(default_factory=list)

    def __post_init__(self):
        self._index: dict[bytes, int] = {
            w: i + 1 for i, w in enumerate(self.words)}

    @property
    def size(self) -> int:
        return len(self.words) + 1

    def id_of(self, word: bytes) -> int:
        return self._index.get(word, UNK)

    def word_of(self, i: int) -> bytes:
        return b"<unk>" if i == 0 else self.words[i - 1]

    @staticmethod
    def from_counts(counts: dict[bytes, int], max_size: int) -> Vocab:
        top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return Vocab([w for w, _ in top[: max_size - 1]])


class HashTokenizer:
    """Stateless fallback: word -> (hash % vocab). No vocab build needed;
    for synthetic-corpus flows where exact inversion is irrelevant."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode_words(self, ws: Iterable[bytes]) -> np.ndarray:
        out = [(hash(w) & 0x7FFFFFFF) % self.vocab_size for w in ws]
        return np.asarray(out, np.int32)

    def encode(self, data: bytes) -> np.ndarray:
        return self.encode_words(words_of(data))


def encode_with_vocab(data: bytes, vocab: Vocab) -> np.ndarray:
    return np.asarray([vocab.id_of(w) for w in words_of(data)], np.int32)
