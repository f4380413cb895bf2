"""Quickstart on the PyTorch/CUDA port: the paper's Listing 1 on the
port's Job API, the job of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--tokens N]

WordCount over 500,000 tokens of ``synth_corpus`` (V 65,536) on P 8
ranks, tasks of 4,096 and a push cap of 1,024, through the one-sided
engine ("1s"), then the bulk-synchronous one ("2s"), whose records must
be the same. Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.core import JobConfig, submit
from repro_torch.core.usecases import WordCount
from repro_torch.data.corpus import synth_corpus

VOCAB = 65_536
N_TOKENS = 500_000


def main(n_tokens: int = N_TOKENS, device=None) -> dict[int, int]:
    """Run the job on ``device`` (cuda unless given); returns MR-1S's
    records after holding them equal to MR-2S's."""
    tokens = synth_corpus(n_tokens, vocab=VOCAB, seed=0)
    cfg = JobConfig(usecase=WordCount(vocab=VOCAB), backend="1s",
                    task_size=4_096, push_cap=1_024, n_procs=8)
    result = submit(cfg, tokens, device=device).result()
    print("top-10 words (id\tcount):")
    for k, v in sorted(result.records.items(), key=lambda kv: -kv[1])[:10]:
        print(f"{k}\t{v}")
    print(f"\n{result.n_tasks} tasks over {len(result.tasks_per_rank)} "
          f"ranks in {result.wall_time:.2f}s "
          f"(imbalance {result.imbalance:.2f})")

    # the bulk-synchronous baseline gives the same answer
    ref = submit(dataclasses.replace(cfg, backend="2s"), tokens,
                 device=device).result()
    assert ref.records == result.records
    print(f"MR-1S == MR-2S result: OK ({len(ref.records)} unique words)")
    return result.records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tokens", type=int, default=N_TOKENS)
    args = ap.parse_args()
    main(args.tokens, args.device)
    sys.exit(0)
