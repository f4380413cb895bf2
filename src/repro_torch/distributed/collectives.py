"""Rank-dimension collectives: the reference's named-axis collectives with
the P ranks as dim 0 of every tensor on one device.

Lockstep semantics match ``shard_map``'s, so a tensor ``x`` here equals
the stack of the P per-rank values the reference would hold.
"""
from __future__ import annotations

import torch


def axis_index(n_procs: int, device) -> torch.Tensor:
    """Each rank's own index: ``(P,)`` int32."""
    return torch.arange(n_procs, dtype=torch.int32, device=device)


def all_to_all_blocks(x: torch.Tensor, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Exchange equal blocks. ``x[i]`` is rank i's ``(P, ...)`` send
    buffer, one block per peer; row j of rank i's result is the block
    rank j addressed to rank i, i.e. ``x[j, i]``. Written into ``out``
    when it is given (the receive buffers stay where they are)."""
    assert x.shape[0] == x.shape[1], x.shape
    if out is None:
        return x.transpose(0, 1).contiguous()
    return out.copy_(x.transpose(0, 1))


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks, replicated back to every rank (dtype kept: int32
    sums wrap mod 2^32 as the reference's do)."""
    s = x.sum(dim=0, keepdim=True, dtype=x.dtype)
    return s.expand_as(x).contiguous()


def tree_gather_permute(x: torch.Tensor, level: int) -> torch.Tensor:
    """The combine tree's collective permute at ``level`` l: rank i
    receives rank i + 2**l's payload for i a multiple of 2**(l+1) (when
    that sender exists). Every other rank receives zeros, exactly as
    ``lax.ppermute`` delivers to non-receivers."""
    P = x.shape[0]
    stride = 1 << level
    rank = torch.arange(P, device=x.device)
    src = rank + stride
    receiver = (rank % (stride * 2) == 0) & (src < P)
    got = x[src.clamp(max=P - 1)]
    mask = receiver.view((P,) + (1,) * (x.dim() - 1))
    return torch.where(mask, got, torch.zeros_like(got))
