"""Skew-aware Word-Count on the PyTorch/CUDA port, beating hash
partitioning on a Zipf corpus: the run of ``examples/skewed_wordcount.py``.

    PYTHONPATH=src python examples/skewed_wordcount_torch.py
        [--tokens N] [--device cpu]

The same job under all three partitioners (``repro_torch/core/
partition.py``): the owner-load imbalance each one produces, its split
keys, and records identical across the three (partitioning is placement,
never semantics). Then the combine-overflow guard: an undersized
``combine_capacity`` raises ``CombineOverflowError`` with the dropped
record count instead of returning wrong counts. Runs on the card unless
given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import (CombineOverflowError, JobConfig,
                              SampledPartitioner, submit)
from repro_torch.core.partition import owner_loads, sample_key_histogram
from repro_torch.core.planner import plan_input, read_tasks
from repro_torch.core.usecases import WordCount
from repro_torch.data.source import ZipfSource

P, N, VOCAB, TASK = 8, 500_000, 65_536, 4_096


def main(n_tokens: int = N, device=None) -> dict:
    """Run the jobs on ``device`` (cuda unless given); returns, by
    partitioner, its owner imbalance, split keys and records."""
    src = ZipfSource(n_tokens, vocab=VOCAB, a=1.8, seed=0)   # zipfy text
    uc = WordCount(vocab=VOCAB)

    out, base = {}, None
    for part in ("hash", "sampled",
                 SampledPartitioner(split=True, split_threshold=0.05)):
        cfg = JobConfig(usecase=uc, backend="1s", task_size=TASK,
                        push_cap=1_024, n_procs=P, partitioner=part)
        with submit(cfg, src, device=device) as h:     # the feed never leaks
            res = h.result()
            # what would each rank receive under this owner map?
            plan = plan_input(n_tokens, TASK, P)
            hist = sample_key_histogram(
                lambda ids: read_tasks(src, plan, ids), plan, uc, 16)
            omap = h.carry.owner_map[0].cpu().numpy()
            osplit = h.carry.owner_split[0].cpu().numpy()
        load = owner_loads(hist, omap, osplit, P)
        imbalance = load.max() / load.mean()
        print(f"{res.partitioner:<14} owner imbalance "
              f"{imbalance:5.2f}   "
              f"split keys {res.n_split_keys:3d}   "
              f"records {len(res.records):,}")
        if base is None:
            base = res.records
        assert res.records == base                      # record-identical
        out[res.partitioner] = dict(imbalance=float(imbalance),
                                    split_keys=res.n_split_keys,
                                    records=res.records)

    # --- the overflow guard --------------------------------------------------
    bad = JobConfig(usecase=uc, backend="1s", task_size=TASK,
                    push_cap=1_024, n_procs=P, combine_capacity=64)
    try:
        submit(bad, src, device=device).result()
    except CombineOverflowError as e:
        print(f"\ncombine_capacity=64 raises as it must: "
              f"{e.result.combine_overflow} records would have been "
              f"silently dropped pre-fix")
        out["overflow"] = e.result.combine_overflow
    else:
        raise AssertionError("combine_capacity=64 did not raise")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tokens", type=int, default=N)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    main(args.tokens, args.device)
    sys.exit(0)
