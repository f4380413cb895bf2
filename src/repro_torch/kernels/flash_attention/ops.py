"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

Takes the ``(B, S, H, hd)`` layout of ``repro/kernels/flash_attention/
ops.py`` and follows the port's kernel policy (``kernels/backend.py``):
a CPU tensor takes the plain version (``ref.flash_attention_plain``), a
CUDA tensor the compiled kernel or an error. The kernel reads the
layout as it is, so the wrapper transposes nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 128)           # the head dims the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = None    # the typed C entry point, resolved at the first launch


def _launcher():
    global _FN
    if _FN is None:
        fn = backend.load(SOURCE).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, H, hd) and k, v (B, Skv, KV, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if Bk != B or hdk != hd or Sq == 0 or Skv == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}: need equal B and hd, S >= 1 "
                         f"and H % KV == 0")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    use_kernel: bool = False):
    """q: (B, S, H, hd); k/v: (B, Skv, KV, hd). Returns (B, S, H, hd).

    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors. On the card the kernel
    takes hd in ``HEAD_DIMS`` and contiguous tensors, and raises on
    anything else.
    """
    _check(q, k, v)
    if not backend.use_kernel(q, require=use_kernel):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B, Sq, Skv, H, KV, hd, int(causal), int(window),
                     hd ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0    # kernel launches so far (not plain calls)
