"""PUMA-style Word-Count under imbalance on the PyTorch/CUDA port: the
paper's section 3 experiment on the Job API, and the engine-built
vocabulary feeding the tokenizer (the ingest path); the run of
``examples/wordcount_puma.py``.

    PYTHONPATH=src python examples/wordcount_puma_torch.py
        [--tokens N] [--device cpu]

MR-2S against MR-1S under the balanced and the unbalanced
``imbalance_repeats`` grids (hot ranks compute 8x), each job warmed up
once and then run; the walls are the device's own and claim nothing.
The records of every run are equal, and the counts build a ``Vocab``.
Runs on the card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core import JobConfig, submit
from repro_torch.core.usecases import WordCount
from repro_torch.data.corpus import imbalance_repeats, synth_corpus
from repro_torch.data.tokenizer import Vocab

N = 2_000_000


def run_engine(tokens, backend, repeats, P=8, device=None):
    cfg = JobConfig(usecase=WordCount(vocab=65_536), backend=backend,
                    task_size=4_096, push_cap=1_024, n_procs=P)
    submit(cfg, tokens, repeats=repeats, device=device).result()   # warm
    return submit(cfg, tokens, repeats=repeats, device=device).result()


def main(n_tokens: int = N, device=None) -> dict:
    """Run the four jobs on ``device`` (cuda unless given); returns their
    walls, the unbalanced imbalance, the records and the Vocab's size."""
    P = 8
    tokens = synth_corpus(n_tokens, vocab=65_536, seed=0)
    T = (len(tokens) + 4_096 * P - 1) // (4_096 * P)

    print("=== balanced workload (paper Fig 4a/4b regime) ===")
    bal = imbalance_repeats(P, T, mode="balanced")
    res2 = run_engine(tokens, "2s", bal, device=device)
    res1 = run_engine(tokens, "1s", bal, device=device)
    print(f"MR-2S {res2.wall_time:.2f}s | MR-1S {res1.wall_time:.2f}s "
          f"({100 * (1 - res1.wall_time / res2.wall_time):+.1f}%)")

    print("\n=== unbalanced workload (hot ranks compute 8x — Fig 4c/4d) ===")
    unb = imbalance_repeats(P, T, mode="unbalanced", hot_factor=8,
                            hot_fraction=0.125)
    res2u = run_engine(tokens, "2s", unb, device=device)
    res1u = run_engine(tokens, "1s", unb, device=device)
    print(f"MR-2S {res2u.wall_time:.2f}s | MR-1S {res1u.wall_time:.2f}s "
          f"({100 * (1 - res1u.wall_time / res2u.wall_time):+.1f}%) "
          f"[imbalance {res1u.imbalance:.2f}]")
    assert res1u.records == res2u.records == res1.records

    # ingest path: the engine's counts build the LM tokenizer vocabulary
    counts = res1.records
    top = {f"word{k}".encode(): v for k, v in counts.items()}
    vocab = Vocab.from_counts(top, max_size=4_096)
    print(f"\nengine-built Vocab: size {vocab.size} "
          f"(top word id {max(counts, key=counts.get)}, "
          f"count {max(counts.values())})")
    return dict(walls={"balanced": (res2.wall_time, res1.wall_time),
                       "unbalanced": (res2u.wall_time, res1u.wall_time)},
                imbalance=res1u.imbalance, records=counts,
                vocab_size=vocab.size)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.tokens, args.device)
    sys.exit(0)
