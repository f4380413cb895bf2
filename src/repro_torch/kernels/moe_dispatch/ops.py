"""Wrapper of the bucket-slot kernel (``csrc/bucket_slots.cu``).

The counterpart of ``repro/kernels/moe_dispatch/ops.py``. Follows the
port's kernel policy (``kernels/backend.py``): a CPU tensor takes the
plain version (``ref.bucket_slots_ref``), a CUDA tensor the compiled
kernel or an error.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.moe_dispatch.ref import bucket_slots_ref

SOURCE = Path(__file__).parent / "csrc" / "bucket_slots.cu"
MAX_EXPERTS = 256    # the (32 warps x E) rank table fills 32 KB of shared memory
BLOCK = 1024         # tokens of one CTA

_FN = None    # the typed C entry point, resolved at the first launch


def _launcher():
    global _FN
    if _FN is None:
        fn = backend.load(SOURCE).bucket_slots_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
            + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def bucket_slots(eids, n_experts: int, *, use_kernel: bool = False):
    """eids: (T,) int32 (an id < 0 or >= E is invalid). Returns (slots (T,)
    int32, -1 for an invalid id; counts (E,) int32), with ``slot[t] =
    #{t' < t : id[t'] == id[t]}``.

    The tensor's device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on a CPU tensor. On the card one call
    is three launches (count, scan, rank), counted once; the kernel takes
    contiguous ids and ``n_experts <= MAX_EXPERTS`` and raises otherwise.
    """
    if eids.dim() != 1 or eids.dtype != torch.int32:
        raise TypeError(f"eids must be (T,) int32, got {tuple(eids.shape)} "
                        f"{eids.dtype}")
    if n_experts < 1:
        raise ValueError(f"n_experts must be >= 1, got {n_experts}")
    if not backend.use_kernel(eids, require=use_kernel):
        return bucket_slots_ref(eids, n_experts)
    if n_experts > MAX_EXPERTS:
        raise ValueError(f"the bucket_slots kernel takes n_experts <= "
                         f"{MAX_EXPERTS}, got {n_experts}")
    if not eids.is_contiguous():
        raise ValueError("eids must be contiguous")
    T = eids.numel()
    slots = torch.empty_like(eids)
    counts = torch.zeros((n_experts,), dtype=torch.int32, device=eids.device)
    if T == 0:
        return slots, counts
    nb = -(-T // BLOCK)
    blk_cnt = torch.empty((nb, n_experts), dtype=torch.int32,
                          device=eids.device)
    blk_off = torch.empty_like(blk_cnt)
    stream = torch.cuda.current_stream(eids.device).cuda_stream
    rc = _launcher()(eids.data_ptr(), T, n_experts, slots.data_ptr(),
                     counts.data_ptr(), blk_cnt.data_ptr(), blk_off.data_ptr(),
                     stream)
    if rc != 0:
        raise RuntimeError(f"bucket_slots kernel launch failed: CUDA error "
                           f"{rc}")
    bucket_slots.launches += 1
    return slots, counts


bucket_slots.launches = 0    # kernel calls so far (not plain calls)
