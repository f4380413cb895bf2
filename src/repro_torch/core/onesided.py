"""MapReduce-1S — the paper's decoupled one-sided engine, ranks as dim 0.

Counterpart of ``repro/core/onesided.py`` (paper §2.1, Fig 1):

  Map + Local Reduce   step t: map_fn -> local_reduce -> bucketize
  one-sided put        the (P, P, cap) buckets swap rank and peer dims
                       (``all_to_all_blocks``); the carry holds the
                       received chunk, folded one step later
  Reduce               incremental: each received chunk is folded into
                       the dense Key-Value window
  ownership transfer   bucket overflow stays local and is folded into the
                       mapper's own window (paper footnote 2)
  Combine              ⌈log2 P⌉-level merge tree (core/combine.py)

The reference's ``lax.scan`` over a segment is a Python loop over its
columns, one step for all P ranks at a time. ``JobSpec.fused_map`` runs
phases II-III of a step as the ``fused_map`` CUDA kernel, which folds
into the carry's window in place; the default path composes the same
torch ops as the kernel's plain version. Both give identical carries.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core.combine import tree_combine
from repro_torch.core.kv import KEY_SENTINEL, bucketize, local_reduce_repeated
from repro_torch.core.partition import lookup_owner
from repro_torch.core.registry import JobSpec, register_backend
from repro_torch.core.windows import (STATUS_REDUCE, DenseWindow,
                                      EngineCarry, combine_records,
                                      init_carry)
from repro_torch.distributed.collectives import all_to_all_blocks
from repro_torch.kernels.fused_map.ops import fused_map


def _step(spec: JobSpec, map_fn: Callable, carry: EngineCarry,
          task, task_id, rep, max_rep: int):
    """One engine step for all ranks: ``task (P, S)``, ``task_id`` and
    ``rep`` (P,), ``max_rep`` the host-known max of ``rep``."""
    P, cap = spec.n_procs, spec.push_cap
    # Phase I: Map (+ simulated imbalance via the repeat factor)
    keys, vals = map_fn(task, task_id, rep, max_rep)
    if spec.fused_map:
        # Phases II+III in one kernel; the window is folded in place
        table, bk, bv, _ = fused_map(
            keys.contiguous(), vals.contiguous(), rep, task_id,
            carry.owner_map, carry.owner_split, carry.pending_k,
            carry.pending_v, carry.table, n_procs=P, cap=cap)
        return carry._replace(table=table, pending_k=all_to_all_blocks(bk),
                              pending_v=all_to_all_blocks(bv),
                              cursor=carry.cursor + 1)
    # Phase II: Local Reduce, re-computed rep[r] times (footnote 5)
    uk, uv = local_reduce_repeated(keys, vals, keys.shape[-1], rep, max_rep)
    owners = lookup_owner(carry.owner_map, carry.owner_split, uk, task_id, P)
    bk, bv, _, (ofk, ofv) = bucketize(uk, uv, P, cap, owners=owners)
    # Phase III (incremental Reduce): fold the previous step's chunk and
    # keep the overflow locally (ownership transfer); in place
    win = DenseWindow(carry.table)
    win.put(carry.pending_k.reshape(P, -1), carry.pending_v.reshape(P, -1))
    win.put(ofk, ofv)
    return carry._replace(pending_k=all_to_all_blocks(bk),
                          pending_v=all_to_all_blocks(bv),
                          cursor=carry.cursor + 1)


def _segment(spec: JobSpec, map_fn: Callable, carry: EngineCarry, tokens,
             task_ids, repeats, max_rep) -> EngineCarry:
    """Advance one segment: ``tokens (P, n, S)``, ``task_ids``/``repeats``
    (P, n) on the device, ``max_rep (n,)`` on the host."""
    tokens = tokens.transpose(0, 1).contiguous()      # (n, P, S)
    task_ids = task_ids.t().contiguous()
    repeats = repeats.t().contiguous()
    for c, m in enumerate(np.asarray(max_rep).tolist()):
        carry = _step(spec, map_fn, carry, tokens[c], task_ids[c],
                      repeats[c], m)
    return carry


def _drain(carry: EngineCarry) -> EngineCarry:
    """Fold the last in-flight chunk; enter STATUS_REDUCE."""
    P = carry.table.shape[0]
    DenseWindow(carry.table).put(carry.pending_k.reshape(P, -1),
                                 carry.pending_v.reshape(P, -1))
    return carry._replace(
        pending_k=torch.full_like(carry.pending_k, KEY_SENTINEL),
        pending_v=torch.zeros_like(carry.pending_v),
        status=torch.full_like(carry.status, STATUS_REDUCE))


def _finish(spec: JobSpec, carry: EngineCarry):
    """Drain, then Combine (phase IV): ``(keys, vals, overflow)`` with
    rank 0's row holding the merged records."""
    carry = _drain(carry)
    keys, vals, overflow = combine_records(carry.table, spec)
    return tree_combine(keys, vals, spec.n_procs, overflow)


@register_backend("1s")
class OneSidedBackend:
    """The decoupled engine behind the ``Backend`` protocol."""

    # honors JobSpec.fused_map (the per-step hot path as one CUDA kernel)
    supports_fused_map = True

    def run_job(self, spec: JobSpec, map_fn: Callable, device, tokens,
                task_ids, repeats):
        """Full job over host arrays tokens (P, T, S) and task_ids/repeats
        (P, T). Returns rank-0 records as host arrays."""
        repeats = np.asarray(repeats, np.int32)
        carry = _segment(
            spec, map_fn, init_carry(spec, device),
            torch.as_tensor(np.asarray(tokens, np.int32)).to(device),
            torch.as_tensor(np.asarray(task_ids, np.int32)).to(device),
            torch.as_tensor(repeats).to(device), repeats.max(axis=0))
        keys, vals, _ = _finish(spec, carry)
        return keys[0].cpu().numpy(), vals[0].cpu().numpy()

    def make_segment_fns(self, spec: JobSpec, map_fn: Callable, device):
        """``(init_fn, segment_fn, finish_fn)`` — the checkpointable path.
        ``segment_fn(carry, tokens, task_ids, repeats, max_rep)`` advances
        one segment; ``finish_fn(carry)`` returns ``(keys, vals,
        overflow)`` with a leading rank dim."""
        return (lambda: init_carry(spec, device),
                lambda carry, tok, tid, rep, max_rep: _segment(
                    spec, map_fn, carry, tok, tid, rep, max_rep),
                lambda carry: _finish(spec, carry))


def run_job(spec, map_fn, device, tokens, task_ids, repeats):
    from repro_torch.core.registry import get_backend
    return get_backend("1s").run_job(spec, map_fn, device, tokens,
                                     task_ids, repeats)


def make_segment_fns(spec, map_fn, device):
    from repro_torch.core.registry import get_backend
    return get_backend("1s").make_segment_fns(spec, map_fn, device)
