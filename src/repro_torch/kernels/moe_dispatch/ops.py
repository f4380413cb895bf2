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
THREADS = 1024       # threads of a CTA, one CTA an SM (kThreads)
# ids a thread the kernel is built for: a tile is THREADS * items ids
ITEMS = (1, 2, 4, 8)
MAX_EXPERTS = 256    # an expert's id fits 8 bits of a packed place
MAX_CALLS = 2**30 - 2    # calls one scratch serves: its epochs are 30 bits

_FN = None    # the typed C entry point, resolved at the first launch
_SCRATCH: dict = {}    # (device, stream) -> [int64 status words, calls]
_SMS: dict = {}        # device -> its SM count, read once


def _launcher():
    global _FN
    if _FN is None:
        fn = backend.load(SOURCE).bucket_slots_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def plan(T: int, sms: int) -> tuple[int, int]:
    """(ids a thread, tiles) of a call on T ids on a card of ``sms`` SMs:
    the fewest ids a thread of ITEMS whose tiles fit one wave of one CTA
    an SM, else the most."""
    for items in ITEMS:
        tiles = -(-T // (THREADS * items))
        if tiles <= sms:
            break
    return items, tiles


def sm_count(device) -> int:
    """The SM count of a CUDA ``device``, read once."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _scratch(device, stream: int, words: int) -> torch.Tensor:
    """The kernel's status words for this device and stream: an epoch
    word, then one word a (tile, expert). Zeroed once when allocated; the
    kernel tags each call's words with the next epoch and advances it, so
    no call fills them. Grows as calls need and is reused by every later
    call on the stream; replaced by a zeroed one before its epochs run
    out."""
    key = (device, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < words or held[1] >= MAX_CALLS:
        n = max(words, held[0].numel() if held is not None else 0)
        held = _SCRATCH[key] = [torch.zeros(n, dtype=torch.int64,
                                            device=device), 0]
    held[1] += 1
    return held[0]


def bucket_slots(eids, n_experts: int, *, use_kernel: bool = False):
    """eids: (T,) int32 (an id < 0 or >= E is invalid). Returns (slots (T,)
    int32, -1 for an invalid id; counts (E,) int32), with ``slot[t] =
    #{t' < t : id[t'] == id[t]}``.

    The tensor's device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on a CPU tensor. On the card one call
    is one launch of one device kernel, counted once; the kernel takes
    contiguous ids, T < 2**31 and ``n_experts <= MAX_EXPERTS`` and raises
    otherwise.
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
    if T >= 2**31:
        raise ValueError(f"the bucket_slots kernel takes T < 2**31, got {T}")
    slots = torch.empty_like(eids)
    if T == 0:
        return slots, torch.zeros((n_experts,), dtype=torch.int32,
                                  device=eids.device)
    counts = torch.empty((n_experts,), dtype=torch.int32, device=eids.device)
    # the current stream's handle, as torch.cuda.current_stream(device)
    # .cuda_stream gives it, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(eids.get_device())
    items, tiles = plan(T, sm_count(eids.device))
    scratch = _scratch(eids.device, stream, 1 + tiles * n_experts)
    rc = _launcher()(eids.data_ptr(), T, n_experts, items, slots.data_ptr(),
                     counts.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"bucket_slots kernel launch failed: CUDA error "
                           f"{rc}")
    bucket_slots.launches += 1
    return slots, counts


bucket_slots.launches = 0    # kernel calls so far (not plain calls)
