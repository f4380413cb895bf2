"""Coded shuffle: r-replicated assignment grids for the XOR multicast.

Counterpart of ``repro/core/coded.py`` (pure numpy, copied so that the
port imports nothing of the reference). Coded MapReduce (arXiv
1512.01625) trades replicated map work for shuffle bytes: when every map
task runs on r ranks, the ranks of an r-group share enough side
information that one XOR-coded block per step replaces the r-1 unicast
bucket transfers inside the group.

This module holds the host half of ``JobConfig(code_rate=r)``:

  * **code groups**: P/r groups of r consecutive ranks,
    ``group = rank // r``, ``member = rank % r``;
  * **replicated grids** (:func:`replicate_grids`): the planner's (P, T)
    grid becomes (P, T·r), column block k of every member of group g the
    group's members' column-k tasks. The engine consumes one block a step
    (T steps, as at r = 1, with r× the map work a step);
  * **bytes model** (:func:`shuffle_bytes`): push-shuffle bytes on the
    wire, the coded intra-group block counted once a step (multicast)
    and each inter-group bucket sent by one speaker.

The device half is ``repro_torch.distributed.collectives.coded_exchange``;
the step that consumes these grids is ``repro_torch.core.onesided.
_coded_step``. With the ranks as a tensor dimension on one card no byte
crosses a wire, so the bytes here are a model, as in the reference.
"""
from __future__ import annotations

import numpy as np

# one shuffled record on the wire: int32 key + int32 value
RECORD_BYTES = 8


def group_of(rank: int, code_rate: int) -> int:
    """Code group of ``rank`` (r consecutive ranks per group)."""
    return rank // code_rate


def member_of(rank: int, code_rate: int) -> int:
    """Member slot of ``rank`` inside its code group."""
    return rank % code_rate


def replicate_grids(task_ids, repeats, code_rate: int):
    """Replicate an r = 1 assignment onto r-rank code groups.

    ``task_ids``/``repeats`` are the planner's (P, T) grids. Returns
    (P, T·r) grids in which every member of group g carries the same row:
    T column blocks of width r, block k holding ``[ids[g·r, k], ...,
    ids[g·r + r - 1, k]]`` (repeats travel with their task). Padding ids
    (-1) replicate like real tasks."""
    ids = np.asarray(task_ids, np.int32)
    reps = np.asarray(repeats, np.int32)
    r = int(code_rate)
    if r <= 1:
        return ids, reps
    P, T = ids.shape
    if P % r:
        raise ValueError(
            f"code_rate={r} needs n_procs divisible into r-rank code "
            f"groups (got n_procs={P})")
    out_ids = np.empty((P, T * r), np.int32)
    out_reps = np.empty((P, T * r), np.int32)
    for g in range(P // r):
        rows = slice(g * r, (g + 1) * r)
        # (r, T) -> (T, r) -> row-major: [block 0 | block 1 | ...]
        out_ids[rows] = ids[rows, :].T.reshape(1, T * r)
        out_reps[rows] = reps[rows, :].T.reshape(1, T * r)
    return out_ids, out_reps


def shuffle_blocks_per_step(n_procs: int, code_rate: int) -> int:
    """Push-shuffle payload blocks one rank puts on the wire a step: at
    r = 1 one bucket a peer; at r > 1 one coded multicast block plus one
    bucket for each other group's destination this member speaks for
    (destination q is spoken for by member q % r of every other group)."""
    P, r = int(n_procs), int(code_rate)
    if r <= 1:
        return P - 1
    return 1 + (P // r - 1)


def shuffle_bytes(n_procs: int, steps: int, push_cap: int,
                  code_rate: int) -> int:
    """Push-shuffle bytes on the wire over ``steps`` engine steps, with
    the fixed-capacity buckets the engine ships."""
    return (int(n_procs) * int(steps)
            * shuffle_blocks_per_step(n_procs, code_rate)
            * int(push_cap) * RECORD_BYTES)
