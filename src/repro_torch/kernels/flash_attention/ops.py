"""Wrapper of the flash attention kernels: ``csrc/flash_attention_bf16.cu``
(bf16, tensor cores) and ``csrc/flash_attention.cu`` (fp32, CUDA cores).

Takes the ``(B, S, H, hd)`` layout of ``repro/kernels/flash_attention/
ops.py`` and follows the port's kernel policy (``kernels/backend.py``):
a CPU tensor takes the plain version (``ref.flash_attention_plain``), a
CUDA tensor the compiled kernel of its dtype or an error. The kernels
read the layout as it is, so the wrapper transposes and pads nothing.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

CSRC = Path(__file__).parent / "csrc"
# each dtype's source and C entry point
SOURCES = {torch.bfloat16: CSRC / "flash_attention_bf16.cu",
           torch.float32: CSRC / "flash_attention.cu"}
_ENTRY = {torch.bfloat16: "flash_attention_bf16_launch",
          torch.float32: "flash_attention_f32_launch"}
# the widths both kernels are instantiated at; a head dim runs on the
# smallest that holds it, with the columns past it zero (``supported``)
WIDTHS = (16, 32, 48, 64, 80, 128, 160)

_FN = {}      # dtype -> the typed C entry point, resolved at first launch


def _launcher(dtype):
    fn = _FN.get(dtype)
    if fn is None:
        fn = getattr(backend.load(SOURCES[dtype]), _ENTRY[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[dtype] = fn
    return fn


def supported(hd: int) -> int | None:
    """The width of the instantiation that runs head dim ``hd``: the
    smallest of ``WIDTHS`` that holds it, for an hd that is a multiple of
    4 from 16 to 160; None for any other hd, which the kernels refuse."""
    if hd % 4 or not WIDTHS[0] <= hd <= WIDTHS[-1]:
        return None
    return next(w for w in WIDTHS if w >= hd)


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
    if q.dtype not in SOURCES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    use_kernel: bool = False):
    """q: (B, S, H, hd); k/v: (B, Skv, KV, hd). Returns (B, S, H, hd).

    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors. On the card bf16 runs
    the tensor-core kernel and fp32 the CUDA-core one; each takes an hd
    that ``supported`` gives a width and contiguous tensors with 16-byte
    aligned data, and raises on anything else.
    """
    _check(q, k, v)
    if not backend.use_kernel(q, require=use_kernel):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    width = supported(hd)
    if width is None:
        raise ValueError(f"the flash_attention kernel takes head dims that "
                         f"are multiples of 4 from {WIDTHS[0]} to "
                         f"{WIDTHS[-1]}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), B, Sq, Skv, H, KV, hd, width,
                            int(causal), int(window), hd ** -0.5, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0    # kernel launches so far (not plain calls)
