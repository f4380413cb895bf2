"""MapReduce-2S — the bulk-synchronous baseline, ranks as dim 0.

Counterpart of ``repro/core/twosided.py`` (Hoefler et al. [7]). Map,
Local Reduce, owner lookup and bucketing are MR-1S's (the paper keeps
them identical on purpose), but:

  * every Map task completes first, buffering *every* task's buckets
    (why its memory scales with the map output — Fig 6);
  * one bulk ``all_to_all`` (MPI_Alltoallv) shuffles everything after
    the implicit barrier;
  * Reduce runs as one spike after the shuffle;
  * the Combine tree is MR-1S's.

The reference maps a segment's tasks with a ``lax.scan`` that carries
nothing: a map over tasks. Here that map runs batched over blocks of
:data:`MAP_BLOCK` tasks a rank (``map_fn`` and the record functions are
row-wise over their leading dims), each block writing its buckets into
the preallocated full send buffer and its overflow into the full
overflow buffer; only a block's temporaries are bounded, every buffer
of the reference lives until the barrier. Any block size gives the same
carry bit for bit.

Registered as backend ``"2s"``. Its segmented path shares
:class:`~repro_torch.core.windows.EngineCarry` with MR-1S, with the
in-flight ``pending_*`` buffers left empty: each segment runs
bulk-synchronously and folds into the carried window, the state the
checkpoint layer snapshots.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core.combine import tree_combine
from repro_torch.core.kv import bucketize, local_reduce_repeated
from repro_torch.core.partition import lookup_owner
from repro_torch.core.registry import JobSpec, register_backend
from repro_torch.core.windows import DenseWindow, combine_records, init_carry
from repro_torch.distributed.collectives import all_to_all_blocks

# tasks a rank mapped in one batched pass: P * MAP_BLOCK rows of S tokens
# (a segment of the documented width is one block)
MAP_BLOCK = 512


def _map_all(spec: JobSpec, map_fn: Callable, tokens, task_ids, repeats,
             max_rep, owner_map, owner_split):
    """The bulk Map phase over a segment: ``tokens (P, n, S)``,
    ``task_ids``/``repeats (P, n)`` on the device, ``max_rep (n,)`` on the
    host. Every task's buckets are buffered before anything is sent (the
    2S memory spike): returns ``[BK, BV, OFK, OFV]``, the send buffers
    ``(P, P, n * cap)`` (one row a destination) and the local overflow
    ``(P, n, L)``."""
    P, cap = spec.n_procs, spec.push_cap
    n, S = tokens.shape[1], tokens.shape[2]
    max_rep = np.asarray(max_rep)
    BK = BV = OFK = OFV = None
    for lo in range(0, n, MAP_BLOCK):
        hi = min(lo + MAP_BLOCK, n)
        B = hi - lo
        tid = task_ids[:, lo:hi]
        rep = repeats[:, lo:hi]
        m = int(max_rep[lo:hi].max())
        # (P * B) rows: map_fn and the record functions are row-wise
        keys, vals = map_fn(tokens[:, lo:hi].reshape(P * B, S),
                            tid.reshape(-1), rep.reshape(-1), m)
        uk, uv = local_reduce_repeated(keys, vals, keys.shape[-1],
                                       rep.reshape(-1), m)
        L = uk.shape[-1]
        uk, uv = uk.view(P, B, L), uv.view(P, B, L)
        owners = lookup_owner(owner_map, owner_split, uk, tid, P)
        bk, bv, _, (ofk, ofv) = bucketize(uk, uv, P, cap, owners=owners)
        if BK is None:
            BK = torch.empty((P, P, n, cap), dtype=bk.dtype,
                             device=bk.device)
            BV = torch.empty_like(BK)
            OFK = torch.empty((P, n, L), dtype=ofk.dtype, device=ofk.device)
            OFV = torch.empty_like(OFK)
        BK[:, :, lo:hi] = bk.transpose(1, 2)     # (P, B, P, cap) -> dest
        BV[:, :, lo:hi] = bv.transpose(1, 2)
        OFK[:, lo:hi] = ofk
        OFV[:, lo:hi] = ofv
    return [BK.view(P, P, n * cap), BV.view(P, P, n * cap), OFK, OFV]


def _shuffle_reduce(table: torch.Tensor, bufs: list):
    """Barrier + bulk shuffle (MPI_Alltoallv), then the Reduce spike:
    everything received, then the local overflow, folded into the
    windows in place. ``bufs`` is :func:`_map_all`'s list, emptied here
    so that the send buffers die at the barrier."""
    P = table.shape[0]
    BK, BV, OFK, OFV = bufs
    bufs.clear()
    RK, RV = all_to_all_blocks(BK), all_to_all_blocks(BV)
    del BK, BV
    win = DenseWindow(table)
    win.put(RK.view(P, -1), RV.view(P, -1))
    del RK, RV
    win.put(OFK.view(P, -1), OFV.view(P, -1))   # overflow kept local


def _segment(spec: JobSpec, map_fn: Callable, carry, tokens, task_ids,
             repeats, max_rep):
    """One bulk-synchronous segment folded into the carried window; the
    cursor advances by the segment's columns."""
    _shuffle_reduce(carry.table, _map_all(
        spec, map_fn, tokens, task_ids, repeats, max_rep, carry.owner_map,
        carry.owner_split))
    return carry._replace(cursor=carry.cursor + tokens.shape[1])


def _finish(spec: JobSpec, carry):
    """Combine (phase IV): ``(keys, vals, overflow)``, rank 0's row
    holding the merged records. Nothing is in flight to drain."""
    keys, vals, overflow = combine_records(carry.table, spec)
    return tree_combine(keys, vals, spec.n_procs, overflow)


@register_backend("2s")
class TwoSidedBackend:
    """The bulk-synchronous engine behind the ``Backend`` protocol. It
    has no fused hot path (no ``supports_fused_map``), as in the
    reference."""

    def run_job(self, spec: JobSpec, map_fn: Callable, device, tokens,
                task_ids, repeats):
        """The blocking path over host arrays tokens (P, T, S) and
        task_ids/repeats (P, T): one segment from a fresh carry, so always
        the hash rule, as the reference's. Returns rank-0 records as host
        arrays."""
        repeats = np.asarray(repeats, np.int32)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(device)

        carry = _segment(spec, map_fn, init_carry(spec, device), dev(tokens),
                         dev(task_ids), dev(repeats), repeats.max(axis=0))
        keys, vals, _ = _finish(spec, carry)
        return keys[0].cpu().numpy(), vals[0].cpu().numpy()

    def trace_handles(self, spec: JobSpec, map_fn: Callable, device,
                      segments: Callable[[int], list], tag: str = ""):
        """Runnable :class:`~repro_torch.core.registry.ProgramHandle`\\ s
        for fleetlint (``repro_torch.analysis``): the segmented triple
        and its replication contract, fed ``segments(seed)``."""
        from repro_torch.core.registry import segment_program_handles
        return segment_program_handles(self, spec, map_fn, device,
                                       segments, tag=tag)

    def make_segment_fns(self, spec: JobSpec, map_fn: Callable, device):
        """``(init_fn, segment_fn, finish_fn)`` over the shared
        EngineCarry: each segment runs bulk-synchronously (map-all, bulk
        shuffle, reduce spike) and folds into the carried window."""
        if spec.coslots > 1:
            # the bulk path never learned to route composite keys
            raise ValueError(
                "backend '2s' does not support cross-job co-scheduling "
                "(coslots > 1) — WorkDomains form over '1s' only")

        def init():
            return init_carry(spec, device)

        def segment(carry, seg):
            return _segment(spec, map_fn, carry, seg.tokens, seg.task_ids,
                            seg.repeats, seg.max_rep)

        def finish(carry):
            return _finish(spec, carry)

        return init, segment, finish


def run_job(spec, map_fn, device, tokens, task_ids, repeats):
    from repro_torch.core.registry import get_backend
    return get_backend("2s").run_job(spec, map_fn, device, tokens,
                                     task_ids, repeats)


def make_segment_fns(spec, map_fn, device):
    from repro_torch.core.registry import get_backend
    return get_backend("2s").make_segment_fns(spec, map_fn, device)
