"""Combine phase — tree merge of the ranks' sorted results.

Counterpart of ``repro/core/combine.py`` (paper §2.1, Fig 3):
⌈log2 P⌉ levels; at level l rank i + 2^l hands its run to rank i, which
merges the two sorted runs summing duplicate keys. After the last level
rank 0 holds the globally sorted result. The ranks are the leading dim,
so the permute is a masked gather (``tree_gather_permute``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.kv import local_reduce
from repro_torch.distributed.collectives import psum, tree_gather_permute


def n_levels(n_procs: int) -> int:
    return int(math.ceil(math.log2(max(n_procs, 2))))


# Overflow totals accumulate across ranks and tree levels in int32; a
# wrapped counter could report 0 lost records after losing 2^32, so they
# saturate at INT32_MAX to keep the "0 means exact" contract.
SAT_MAX = 2**31 - 1


def sat_add_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Saturating int32 add for non-negative operands: wrap -> SAT_MAX."""
    s = a.to(torch.int64) + b.to(torch.int64)
    return s.clamp(max=SAT_MAX).to(torch.int32)


def _sat_psum(x: torch.Tensor, n_procs: int) -> torch.Tensor:
    """psum of non-negative int32 counts that cannot wrap: each rank's
    contribution is pre-clamped to SAT_MAX // P, so the P-way sum stays
    inside int32; a clamped contribution already means the true total
    saturates."""
    cap = SAT_MAX // max(n_procs, 1)
    return psum(x.to(torch.int32).clamp(max=cap))


def tree_combine(keys: torch.Tensor, vals: torch.Tensor, n_procs: int,
                 overflow: torch.Tensor | None = None):
    """Run the merge tree over ``(P, W)`` sorted, sentinel-padded runs.

    ``overflow`` seeds each rank's count of records already lost before
    the tree (``combine_records``). Returns ``(keys, vals, total)``:
    rank 0 holds the merged records (other ranks their last partial
    state), and ``total`` is the ``(P,)`` replicated, saturating global
    count of records dropped on the way to rank 0.
    """
    P, W = keys.shape
    rank = torch.arange(P, device=keys.device)
    if overflow is None:
        overflow = torch.zeros((P,), dtype=torch.int32, device=keys.device)
    total = _sat_psum(overflow, n_procs)
    for level in range(n_levels(n_procs)):
        stride = 1 << level
        rk = tree_gather_permute(keys, level)
        rv = tree_gather_permute(vals, level)
        # non-receivers get zeros; their merge is computed and masked
        # away, as in the reference
        is_receiver = (rank % (stride * 2) == 0) & (rank + stride < P)
        mk, mv, n_union = local_reduce(torch.cat([keys, rk], dim=-1),
                                       torch.cat([vals, rv], dim=-1), W)
        lost = torch.where(is_receiver, (n_union - W).clamp(min=0), 0)
        total = sat_add_i32(total, _sat_psum(lost, n_procs))
        keys = torch.where(is_receiver.unsqueeze(-1), mk, keys)
        vals = torch.where(is_receiver.unsqueeze(-1), mv, vals)
    return keys, vals, total
