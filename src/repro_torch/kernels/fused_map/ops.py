"""Wrapper of the fused 1S step kernel (``csrc/fused_map.cu``).

Follows the port's kernel policy (``kernels/backend.py``): a CPU tensor
takes the plain version (``ref.fused_step_ref``), a CUDA tensor the
compiled kernel or an error. Either way the window ``table`` is updated
in place and returned, so the two paths have one contract.

A launch recorded into a CUDA graph under capture is not a launch: it
counts in ``fused_map.captured``, and whoever replays the graph adds one
to ``fused_map.launches`` for each replay (``core/onesided.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fused_map.ref import fused_step_ref

SOURCE = Path(__file__).parent / "csrc" / "fused_map.cu"
MAX_TASK_SIZE = 1024    # 2 S pairs sorted two a thread: 1,024 threads


_FN = None    # the typed C entry point, resolved at the first launch


def _launcher():
    """The kernel's C entry point: built, loaded and its shared-memory
    limit raised on the first call, which must not be under capture."""
    global _FN
    if _FN is None:
        lib = backend.load(SOURCE)
        rc = lib.fused_map_prepare()
        if rc != 0:
            raise RuntimeError(f"fused_map_prepare failed: CUDA error {rc}")
        fn = lib.fused_map_launch
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def prepare():
    """Build and load the kernel now (before a graph capture records it)."""
    _launcher()


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
    bk = torch.empty((P, P, cap), dtype=torch.int32, device=keys.device)
    bv = torch.empty_like(bk)
    counts = torch.empty((P, P), dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = _launcher()(
        *(t.data_ptr() for t in args.values()),
        bk.data_ptr(), bv.data_ptr(), counts.data_ptr(),
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
