"""Plain PyTorch version of the fused 1S step.

The unfused hot path of :func:`repro_torch.core.onesided._step` between
``map_fn`` and the all_to_all push, as one function: local reduce (with
the footnote-5 repeat loop) -> owner lookup against the carried
partition maps -> bucketize into per-owner push buckets -> fold of the
previous step's in-flight chunk plus this step's overflow into the
window. The CUDA kernel must equal it bit for bit on every output: all
arithmetic is int32, so the sums are order-free mod 2^32.
"""
from __future__ import annotations

from repro_torch.core.kv import bucketize, local_reduce_repeated
from repro_torch.core.partition import lookup_owner
from repro_torch.core.windows import DenseWindow


def fused_step_ref(keys, vals, rep, task_id, owner_map, owner_split,
                   pending_k, pending_v, table, *, n_procs: int, cap: int):
    """One fused engine step for all P ranks.

    ``keys``/``vals`` (P, S) are the ranks' mapped records, ``rep`` and
    ``task_id`` (P,) their compute repeats and global task ids,
    ``owner_map``/``owner_split`` (P, V) the carried partition maps,
    ``pending_k``/``pending_v`` (P, P, cap) the previous step's in-flight
    chunk and ``table`` (P, V) the windows (not modified).

    Returns ``(table, bk, bv, counts)``: the folded windows, the
    (P, P, cap) push buckets and the (P, P) per-owner fill counts.
    """
    P = keys.shape[0]
    uk, uv = local_reduce_repeated(keys, vals, keys.shape[-1], rep,
                                   int(rep.max()))
    owners = lookup_owner(owner_map, owner_split, uk, task_id, n_procs)
    bk, bv, counts, (ofk, ofv) = bucketize(uk, uv, n_procs, cap,
                                           owners=owners)
    win = DenseWindow(table.clone())
    win.put(pending_k.reshape(P, -1), pending_v.reshape(P, -1))
    win.put(ofk, ofv)
    return win.table, bk, bv, counts
