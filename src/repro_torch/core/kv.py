"""Key-value record machinery, batched over the leading rank dim.

Counterpart of ``repro/core/kv.py``: fixed-width int32 records, the
Murmur3 fmix32 ownership hash and the sort-based local reduce. Every
function takes ``(..., L)`` record arrays and works on the last dim, so
``(P, L)`` runs all P ranks at once with each rank's result equal to the
reference's on that rank's row.

int32 arithmetic wraps mod 2^32 as the reference's does. PyTorch has no
uint32 ``>>`` or ``%`` on every device, so :func:`mix32` computes in
int64 masked to 32 bits and returns the uint32 value held in int64.
"""
from __future__ import annotations

import torch

KEY_SENTINEL = 2**31 - 1            # marks an empty / invalid record
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32) held in int64, split in
    16-bit halves of ``c`` so no int64 product can overflow."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 of ``x`` read as uint32 (so -1 is 0xFFFFFFFF);
    the result is the uint32 hash held in an int64 tensor."""
    x = x.to(torch.int64) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def owner_of(keys: torch.Tensor, n_procs: int) -> torch.Tensor:
    """hash(key) % P — the paper's ownership rule."""
    return (mix32(keys) % n_procs).to(torch.int32)


def local_reduce(keys: torch.Tensor, values: torch.Tensor, capacity: int):
    """Paper phase II (Local Reduce): aggregate duplicate keys.

    Sorts by key and segment-sums, returning ``capacity`` records per row
    (key ascending, KEY_SENTINEL padding) and each row's unique count.
    """
    sk, order = torch.sort(keys, dim=-1, stable=True)
    sv = values.gather(-1, order)
    valid = sk != KEY_SENTINEL
    head = torch.ones_like(valid)
    head[..., 1:] = sk[..., 1:] != sk[..., :-1]
    head &= valid
    seg = torch.cumsum(head, dim=-1) - 1
    # ghost slot ``capacity`` for past-capacity writes, so slot
    # capacity-1 is never clobbered when n_unique == capacity (the
    # reference's scatter drops them likewise). Invalid records sort last
    # (KEY_SENTINEL is the largest key) and add 0 to a live slot; slots
    # past n_unique are never written, so they keep their fill values.
    batch = keys.shape[:-1]
    sums = torch.zeros(batch + (capacity + 1,), dtype=values.dtype,
                       device=keys.device)
    sums.scatter_add_(-1, seg.clamp(0, capacity), torch.where(valid, sv, 0))
    uk = torch.full(batch + (capacity + 1,), KEY_SENTINEL,
                    dtype=keys.dtype, device=keys.device)
    uk.scatter_(-1, torch.where(head, seg, capacity).clamp(max=capacity),
                sk)
    n_unique = head.sum(dim=-1, dtype=torch.int32)
    return uk[..., :capacity], sums[..., :capacity], n_unique


def local_reduce_repeated(keys, vals, capacity: int, rep: torch.Tensor,
                          max_rep: int):
    """Paper footnote 5 imbalance model: row r's task is *computed*
    ``max(rep[r], 1)`` times while its input is read once.

    Each extra repetition re-runs a full local_reduce seeded with the
    reference's value-preserving dependency on the previous iteration
    (``uv < 0``), so even wrap-negative sums replay exactly: the
    recurrence is not idempotent there, and row r keeps the result of
    exactly its own ``rep[r]`` iterations. ``max_rep`` is the host-known
    maximum of ``rep`` (the loop bound; no device sync)."""
    uk, uv, _ = local_reduce(keys, vals, capacity)
    for i in range(1, max(int(max_rep), 1)):
        neg = uv < 0
        k_dep = torch.where(neg, uk, KEY_SENTINEL)
        v_dep = torch.where(neg, uv, 0)
        uk2, uv2, _ = local_reduce(torch.cat([keys, k_dep], dim=-1),
                                   torch.cat([vals, v_dep], dim=-1),
                                   capacity)
        live = (rep > i).unsqueeze(-1)
        uk = torch.where(live, uk2, uk)
        uv = torch.where(live, uv2, uv)
    return uk, uv


def merge_sorted(keys_a, vals_a, keys_b, vals_b, capacity: int):
    """Merge two key-ascending unique record arrays, summing duplicates."""
    return local_reduce(torch.cat([keys_a, keys_b], dim=-1),
                        torch.cat([vals_a, vals_b], dim=-1), capacity)[:2]


def bucketize(keys, values, n_procs: int, cap: int, owners=None):
    """Scatter records into per-owner push buckets: ``(..., P, cap)``
    records plus ``(..., P)`` fill counts.

    ``owners`` overrides ``hash(key) % P`` with a per-record owner array
    (values in [0, n_procs]). Records beyond ``cap`` for a hot owner are
    dropped from the push and returned as ``overflow`` so the caller
    keeps them locally (ownership transfer, paper footnote 2).
    """
    if owners is None:
        owners = owner_of(keys, n_procs)
    valid = keys != KEY_SENTINEL
    owners = torch.where(valid, owners, n_procs)     # invalid -> ghost
    so, order = torch.sort(owners, dim=-1, stable=True)
    sk, sv = keys.gather(-1, order), values.gather(-1, order)
    batch, L = keys.shape[:-1], keys.shape[-1]
    bounds = torch.arange(n_procs + 1, dtype=so.dtype, device=so.device)
    start = torch.searchsorted(so, bounds.expand(batch + (n_procs + 1,))
                               .contiguous())
    pos = (torch.arange(L, device=so.device)
           - start.gather(-1, so.clamp(0, n_procs).long()))
    counts = (start[..., 1:] - start[..., :-1]).clamp(max=cap) \
        .to(torch.int32)
    in_cap = (pos < cap) & (so < n_procs)
    flat = torch.where(in_cap, so.long() * cap + pos, n_procs * cap)
    bk = torch.full(batch + (n_procs * cap + 1,), KEY_SENTINEL,
                    dtype=keys.dtype, device=keys.device)
    bk.scatter_(-1, flat, torch.where(in_cap, sk, KEY_SENTINEL))
    bv = torch.zeros(batch + (n_procs * cap + 1,), dtype=values.dtype,
                     device=keys.device)
    bv.scatter_(-1, flat, torch.where(in_cap, sv, 0))
    bk = bk[..., :-1].reshape(batch + (n_procs, cap))
    bv = bv[..., :-1].reshape(batch + (n_procs, cap))
    kept = in_cap | (so >= n_procs)
    overflow_k = torch.where(kept, KEY_SENTINEL, sk)
    overflow_v = torch.where(kept, 0, sv)
    return bk, bv, counts, (overflow_k, overflow_v)
