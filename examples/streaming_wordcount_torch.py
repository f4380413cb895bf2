"""Streaming Word-Count on the PyTorch/CUDA port: the paper's non-blocking
I/O on a dataset that is never fully resident, the run of
``examples/streaming_wordcount.py``.

    PYTHONPATH=src python examples/streaming_wordcount_torch.py
        [--tokens N] [--device cpu]

Two memory-mapped token files and a lazy Zipf tail, presented as one
stream (``ConcatSource``), are read segment by segment (``segment=4``,
``handle.step()``): the ``SegmentFeed`` reads the next segment's tasks
by file offset in a background thread while the engine computes the
current one, so the host holds O(segment). The bulk-synchronous engine
gives the same records. ``--tokens`` splits as the reference does: two
fifths a file and the rest the tail (1,000,000 by default). Runs on the
card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch.core import JobConfig, submit
from repro_torch.core.usecases import WordCount
from repro_torch.data.corpus import synth_corpus
from repro_torch.data.source import (ConcatSource, MmapTokenSource,
                                     ZipfSource)

N = 1_000_000


def main(n_tokens: int = N, device=None) -> dict[int, int]:
    """Run both engines over the stream on ``device`` (cuda unless
    given); returns MR-1S's records after holding them equal to
    MR-2S's."""
    part = 2 * n_tokens // 5
    with tempfile.TemporaryDirectory() as d:
        # a sharded on-disk corpus: two mmap'd part files + a lazy
        # synthetic tail, as one stream (nothing below materializes it)
        for i in range(2):
            synth_corpus(part, vocab=65_536, seed=i).tofile(
                os.path.join(d, f"part-{i}.bin"))
        source = ConcatSource([
            MmapTokenSource(os.path.join(d, "part-0.bin")),
            MmapTokenSource(os.path.join(d, "part-1.bin")),
            ZipfSource(n_tokens - 2 * part, vocab=65_536, seed=9),
        ])
        print(f"streaming {source.len_elements():,} tokens "
              f"({source.len_elements() * 4 / 2**20:.0f} MiB on disk/lazy)")

        cfg = JobConfig(usecase=WordCount(vocab=65_536), backend="1s",
                        task_size=4_096, push_cap=1_024, n_procs=8,
                        segment=4)
        handle = submit(cfg, source, device=device)   # no pre-shard or read
        while handle.step():
            pass                           # the next segment prefetches
        result = handle.result()

        st = handle.feed.stats
        print(f"{result.n_tasks} tasks in {result.wall_time:.2f}s | "
              f"{st.prefetch_hits}/{st.segments_built} segments prefetched, "
              f"peak feed residency {st.max_live_bytes / 2**20:.2f} MiB "
              f"vs {st.bytes_read / 2**20:.0f} MiB streamed")

        # the same answer from the bulk-synchronous engine over the stream
        ref = submit(dataclasses.replace(cfg, backend="2s"), source,
                     device=device).result()
        assert ref.records == result.records
        print(f"MR-1S == MR-2S over the stream: OK "
              f"({len(ref.records)} unique words)")
    return result.records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.tokens, args.device)
    sys.exit(0)
