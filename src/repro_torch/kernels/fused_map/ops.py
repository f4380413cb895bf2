"""Wrapper of the fused 1S step kernel (``csrc/fused_map.cu``).

Follows the port's kernel policy (``kernels/backend.py``): a CPU tensor
takes the plain version (``ref.fused_step_ref``), a CUDA tensor the
compiled kernel or an error. Either way the window ``table`` is updated
in place and returned, so the two paths have one contract.

A launch recorded into a CUDA graph under capture is not a launch: it
counts in ``fused_map.captured``, and whoever replays the graph adds one
to ``fused_map.launches`` for each replay (``core/onesided.py``).

The kernel takes task sizes 1 to ``MAX_TASK_SIZE``. Past S 4,096 its
sort and records do not fit a block's shared memory and go to an int32
scratch in device memory (``_scratch``): one buffer for each device and
size (P ranks of 6 pow2(2 S) ints), made at the first launch of that
size and kept, since a CUDA graph that captured a launch replays into
it. Launches of one size share it, so they run in one stream's order, as
every caller of the port launches them; a capture needs its scratch made
before it begins (``prepare(S, P, device)``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fused_map.ref import fused_step_ref

SOURCE = Path(__file__).parent / "csrc" / "fused_map.cu"
MAX_TASK_SIZE = 16384   # NP = pow2(2 S) pairs, 32 a thread on 1,024 threads


_LIB = None   # the library, its entry points typed, at the first launch
_SCRATCH: dict = {}     # (device, ints) -> the launches' int32 scratch


def _lib():
    """The kernel's library: built, loaded and its shared-memory limit
    raised on the first call, which must not be under capture."""
    global _LIB
    if _LIB is None:
        lib = backend.load(SOURCE)
        rc = lib.fused_map_prepare()
        if rc != 0:
            raise RuntimeError(f"fused_map_prepare failed: CUDA error {rc}")
        lib.fused_map_launch.argtypes = [ctypes.c_void_p] * 13 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.fused_map_launch.restype = ctypes.c_int
        lib.fused_map_scratch_ints.argtypes = [ctypes.c_int] * 2
        lib.fused_map_scratch_ints.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _scratch(device, P: int, S: int):
    """The scratch of launches at (P, S) on ``device``, or None where the
    kernel keeps a pass in shared memory: as long as the source's
    ``fused_map_scratch_ints`` says, made outside any capture and never
    freed (a captured graph keeps its pointer)."""
    n = _lib().fused_map_scratch_ints(P, S)
    if n == 0:
        return None
    key = (torch.device(device), n)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"fused_map at S={S}, P={P} needs its scratch made before a "
                f"graph capture: call prepare({S}, {P}, device) first")
        buf = _SCRATCH[key] = torch.empty(n, dtype=torch.int32,
                                          device=device)
    return buf


def prepare(S: int, P: int, device):
    """Build and load the kernel now and make the scratch of launches at
    task size ``S`` and ``P`` ranks on ``device``: both before a graph
    capture records a launch."""
    _scratch(device, P, S)


def _check(args: dict, n_procs: int, cap: int):
    keys = args["keys"]
    P, S = keys.shape
    V = args["table"].shape[-1]
    want = {"keys": (P, S), "vals": (P, S), "rep": (P,), "task_id": (P,),
            "owner_map": (P, V), "owner_split": (P, V),
            "pending_k": (P, P, cap), "pending_v": (P, P, cap),
            "table": (P, V)}
    if P != n_procs:
        raise ValueError(f"keys carry {P} ranks, n_procs={n_procs}")
    if S < 1:
        raise ValueError(f"fused_map takes a task size >= 1, got {S}")
    for name, t in args.items():
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on "
                             f"{keys.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_map(keys, vals, rep, task_id, owner_map, owner_split, pending_k,
              pending_v, table, *, n_procs: int, cap: int,
              use_kernel: bool = False):
    """One fused engine step for all P ranks (see ``ref.fused_step_ref``
    for the arguments). Folds into ``table`` in place and returns
    ``(table, bk, bv, counts)``, equal bit for bit to the plain version.
    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors.
    """
    args = dict(keys=keys, vals=vals, rep=rep, task_id=task_id,
                owner_map=owner_map, owner_split=owner_split,
                pending_k=pending_k, pending_v=pending_v, table=table)
    _check(args, n_procs, cap)
    if not backend.use_kernel(keys, require=use_kernel):
        new_table, bk, bv, counts = fused_step_ref(**args, n_procs=n_procs,
                                                   cap=cap)
        table.copy_(new_table)
        return table, bk, bv, counts
    P, S = keys.shape
    if S > MAX_TASK_SIZE:
        raise ValueError(f"the fused_map kernel takes task sizes up to "
                         f"{MAX_TASK_SIZE}, got {S}")
    scratch = _scratch(keys.device, P, S)
    bk = torch.empty((P, P, cap), dtype=torch.int32, device=keys.device)
    bv = torch.empty_like(bk)
    counts = torch.empty((P, P), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _lib().fused_map_launch(
        *(t.data_ptr() for t in args.values()),
        bk.data_ptr(), bv.data_ptr(), counts.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        P, S, table.shape[-1], cap, stream)
    if rc != 0:
        raise RuntimeError(f"fused_map kernel launch failed: CUDA error "
                           f"{rc}")
    if torch.cuda.is_current_stream_capturing():
        fused_map.captured += 1
    else:
        fused_map.launches += 1
    return table, bk, bv, counts


fused_map.launches = 0    # kernel launches so far (not plain-version calls)
fused_map.captured = 0    # launches recorded into CUDA graphs
