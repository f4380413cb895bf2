"""Double-buffered host -> device pipeline for LM training batches
(counterpart of ``repro/data/pipeline.py``), the non-blocking-I/O
analogue: the paper overlaps each Map task's compute with the
asynchronous retrieval of the next task's input.

``DoubleBufferedLoader`` keeps exactly one batch in flight. On a card
each host batch is copied into pinned memory and sent to the device
``non_blocking`` on a side stream, while the step on the current stream
runs; the consumer's stream waits on that copy's event before it uses
the batch, and each device tensor is marked as used on the consumer's
stream (``record_stream``), so the caching allocator does not hand its
memory out again while the consumer's work is pending. Each batch gets
pinned buffers of its own, which the pinned allocator does not reuse
until the copy that reads them has completed. On the CPU the loader
hands the host batches through as tensors.

MapReduce jobs stream through ``repro_torch.data.feed.SegmentFeed``;
this module is the LM-training batch pipeline.
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


class DoubleBufferedLoader:
    """Wraps a host batch iterator (dicts of numpy arrays); yields dicts
    of tensors on ``device`` (cuda unless given), the next one in
    flight."""

    def __init__(self, host_iter: Iterator, device=None):
        self.device = resolve_device(device)
        self._it = iter(host_iter)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._next = self._put(next(self._it, None))

    def _put(self, host_batch):
        """Start the batch's transfer: (device batch, copy event)."""
        if host_batch is None:
            return None
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in host_batch.items()}
        if self._stream is None:
            return tensors, None
        with torch.cuda.stream(self._stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True)
                   for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is None:
            raise StopIteration
        out, event = self._next
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        # start the following transfer before the caller blocks on `out`
        self._next = self._put(next(self._it, None))
        return out


def lm_batches(tokens: np.ndarray, batch: int, seq: int, *,
               n_steps: int | None = None, seed: int = 0,
               skip: int = 0):
    """Yield {tokens, labels} LM batches (int32) from a flat token stream.

    ``skip`` fast-forwards the sampling RNG: a restore replays the exact
    batch sequence."""
    n_per = batch * (seq + 1)
    rng = np.random.default_rng(seed)
    for _ in range(skip):
        rng.integers(0, max(1, len(tokens) - n_per - 1))
    step = 0
    while n_steps is None or step < n_steps:
        start = int(rng.integers(0, max(1, len(tokens) - n_per - 1)))
        window = tokens[start: start + n_per]
        if len(window) < n_per:
            window = np.pad(window, (0, n_per - len(window)))
        grid = window.reshape(batch, seq + 1)
        yield {"tokens": grid[:, :-1].astype(np.int32),
               "labels": grid[:, 1:].astype(np.int32)}
        step += 1
