"""DataSource — the streaming dataset side of the Job API.

A numpy copy of ``repro/data/source.py`` (the slice's sources). A
:class:`DataSource` is offset-addressable: ``len_elements()`` and a pure,
thread-safe ``read(offset, size)`` (short at EOF), which is what lets the
feed read ahead of the engine.

  * :class:`ArraySource`     — resident numpy array (``submit`` wraps
                               raw arrays);
  * :class:`MmapTokenSource` — memory-mapped token file;
  * :class:`ZipfSource`      — lazy synthetic PUMA-like corpus, generated
                               per fixed-size block on read;
  * :class:`ConcatSource`    — concatenation of sources;
  * :class:`FleetSource`     — member sources at a fixed element stride
                               (a WorkDomain's composite address space).
"""
from __future__ import annotations

import os
from collections.abc import Sequence
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class DataSource(Protocol):
    """Offset-addressable int32 element stream."""

    def len_elements(self) -> int:
        ...

    def read(self, offset: int, size: int) -> np.ndarray:
        """Elements ``[offset, offset+size)`` as int32; short at EOF,
        empty past it. Must be pure and thread-safe."""
        ...


def as_source(dataset) -> DataSource:
    """Pass a DataSource through; wrap anything array-like."""
    if isinstance(dataset, DataSource) and not isinstance(dataset,
                                                          np.ndarray):
        return dataset
    return ArraySource(dataset)


def read_all(source: DataSource, block: int = 1 << 20) -> np.ndarray:
    """Materialize a source (oracle helper — O(dataset) host RAM)."""
    n = source.len_elements()
    out = np.empty((n,), np.int32)
    filled = 0
    while filled < n:
        chunk = source.read(filled, min(block, n - filled))
        out[filled: filled + len(chunk)] = chunk
        filled += len(chunk)
    return out


class ArraySource:
    """A resident in-memory array behind the DataSource contract."""

    def __init__(self, array):
        self._array = np.asarray(array, np.int32).reshape(-1)

    def len_elements(self) -> int:
        return len(self._array)

    def read(self, offset: int, size: int) -> np.ndarray:
        return self._array[offset: offset + size]


class MmapTokenSource:
    """Memory-mapped flat token file of ``dtype`` (default int32)."""

    def __init__(self, path: str, dtype=np.int32):
        self.path = path
        self._dtype = np.dtype(dtype)
        self._n = os.path.getsize(path) // self._dtype.itemsize
        self._mm = np.memmap(path, dtype=self._dtype, mode="r",
                             shape=(self._n,))

    def len_elements(self) -> int:
        return self._n

    def read(self, offset: int, size: int) -> np.ndarray:
        return np.asarray(self._mm[offset: offset + size], np.int32)


class ZipfSource:
    """Lazy synthetic Zipf corpus generated per read.

    Element i belongs to block ``i // block``, and each block comes from
    its own counter-keyed RNG, so ``read`` is deterministic whatever the
    read order — and equal to the reference's ``ZipfSource`` element for
    element.
    """

    def __init__(self, n: int, vocab: int, a: float = 1.3, seed: int = 0,
                 block: int = 65536):
        self.n, self.vocab, self.a, self.seed = n, vocab, a, seed
        self.block = block
        self._cache = (-1, None)    # last generated (block, tokens)

    def len_elements(self) -> int:
        return self.n

    def _gen_block(self, b: int) -> np.ndarray:
        cached_b, cached = self._cache      # atomic tuple read: a race
        if cached_b == b:                   # only regenerates
            return cached
        rng = np.random.default_rng([self.seed, b])
        size = min(self.block, self.n - b * self.block)
        blk = (rng.zipf(self.a, size=size) % self.vocab).astype(np.int32)
        self._cache = (b, blk)
        return blk

    def read(self, offset: int, size: int) -> np.ndarray:
        end = min(offset + size, self.n)
        if end <= offset:
            return np.empty((0,), np.int32)
        out = np.empty((end - offset,), np.int32)
        for b in range(offset // self.block, (end - 1) // self.block + 1):
            blk = self._gen_block(b)
            lo = max(offset, b * self.block)
            hi = min(end, b * self.block + len(blk))
            out[lo - offset: hi - offset] = blk[lo - b * self.block:
                                                hi - b * self.block]
        return out


class ConcatSource:
    """Concatenation of sources presented as one contiguous stream."""

    def __init__(self, sources: Sequence[DataSource]):
        self._sources = list(sources)
        self._starts = np.cumsum([0] + [s.len_elements()
                                        for s in self._sources])

    def len_elements(self) -> int:
        return int(self._starts[-1])

    def read(self, offset: int, size: int) -> np.ndarray:
        end = min(offset + size, self.len_elements())
        if end <= offset:
            return np.empty((0,), np.int32)
        parts = []
        i = int(np.searchsorted(self._starts[1:], offset, side="right"))
        while offset < end:
            lo = offset - int(self._starts[i])
            take = min(end, int(self._starts[i + 1])) - offset
            parts.append(self._sources[i].read(lo, take))
            offset += take
            i += 1
        return np.concatenate(parts) if len(parts) > 1 else parts[0]


class FleetSource:
    """K member sources at a fixed element stride.

    Member j occupies ``[j * stride, (j + 1) * stride)``: its own
    elements first, then an empty pad region (reads there return
    nothing, so the planner's sentinel padding matches a solo run). With
    ``stride = costride * task_size`` the composite task id ``slot *
    costride + local`` of a :class:`~repro_torch.core.workdomain.
    WorkDomain` lands on the bytes the member's solo plan reads, so
    ``plan.file_offset`` serves any member's task unchanged. A read stops
    at the end of its member's window."""

    def __init__(self, sources: Sequence[DataSource], stride: int):
        self._sources = [as_source(s) for s in sources]
        self.stride = int(stride)
        for j, s in enumerate(self._sources):
            if s.len_elements() > self.stride:
                raise ValueError(
                    f"member {j} holds {s.len_elements()} elements — more "
                    f"than the fleet stride {self.stride}")

    def len_elements(self) -> int:
        return self.stride * len(self._sources)

    def read(self, offset: int, size: int) -> np.ndarray:
        j = offset // self.stride
        if not 0 <= j < len(self._sources):
            return np.empty((0,), np.int32)
        local = offset - j * self.stride
        take = min(size, self.stride - local)    # stop at the boundary
        return self._sources[j].read(local, take)
