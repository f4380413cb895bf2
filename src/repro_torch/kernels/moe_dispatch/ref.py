"""Plain PyTorch version of the bucket-slot kernel, and its oracle.

``bucket_slots_ref`` is the reference's oracle
(``repro/kernels/moe_dispatch/ref.py::bucket_slots_ref``), which equals
its TPU kernel (``kernel.py::_slots_kernel``) on every input, invalid
ids included: one-hot the ids against the E experts, take the inclusive
cumsum over tokens, and pick each record's own column minus one. An id
below 0 or at or above E gets slot -1 and is not counted. All int32, so
the CUDA kernel must equal it bit for bit.
"""
from __future__ import annotations

import torch


def bucket_slots_ref(eids: torch.Tensor, n_experts: int):
    """eids: (T,) int32. Returns (slots (T,) int32 with -1 for an invalid
    id, counts (E,) int32): ``slot[t] = #{t' < t : id[t'] == id[t]}``."""
    valid = (eids >= 0) & (eids < n_experts)
    experts = torch.arange(n_experts, device=eids.device)
    oh = ((eids[:, None] == experts[None, :]) & valid[:, None]).to(torch.int32)
    prefix = torch.cumsum(oh, dim=0, dtype=torch.int32) - 1
    picked = prefix.gather(
        1, eids.clamp(0, n_experts - 1).to(torch.int64)[:, None])[:, 0]
    slots = torch.where(valid, picked, torch.full_like(picked, -1))
    return slots, oh.sum(0, dtype=torch.int32)
