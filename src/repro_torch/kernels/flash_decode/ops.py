"""Wrapper of the flash-decode kernel (``csrc/flash_decode.cu``).

Takes the layout of ``repro/kernels/flash_decode/ops.py::flash_decode``
(q (B, H, hd); k, v (B, S, KV, hd)) and follows the port's kernel policy
(``kernels/backend.py``): a CPU tensor takes the plain version
(``ref.flash_decode_plain``), a CUDA tensor the compiled kernel or an
error. The kernel reads q, k and v in place with their strides, so the
wrapper transposes nothing, and reads a tensor ``t`` on the device, so a
decode loop never waits on the host.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_decode.ref import flash_decode_plain

SOURCE = Path(__file__).parent / "csrc" / "flash_decode.cu"
HEAD_DIMS = (32, 64, 80, 128)   # the head dims the kernel is built for
MAX_GROUP = 16                  # query heads per KV head
TILE = 64                       # keys of a staged tile
CTAS_PER_SM = 4                 # CTAs the split aims for on each SM
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = None    # the typed C entry point, resolved at the first launch


def _launcher():
    global _FN
    if _FN is None:
        fn = backend.load(SOURCE).flash_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q, k, v, t):
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, hd) and k, v (B, S, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, S, KV, hdk = k.shape
    if Bk != B or hdk != hd or S == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}: need equal B and hd, S >= 1 "
                         f"and H % KV == 0")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if torch.is_tensor(t) and (t.dim() != 0 or t.dtype != torch.int32):
        raise TypeError(f"t must be an int or a 0-dim int32 tensor, got "
                        f"{tuple(t.shape)} {t.dtype}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_plan(B: int, S: int, KV: int, block_kv: int,
               sms: int) -> tuple[int, int]:
    """(splits, keys per split): enough splits of the cache that B*KV*splits
    CTAs put ``CTAS_PER_SM`` on each of the card's ``sms`` SMs, none longer
    than ``block_kv`` rounded up to a tile, each a whole number of
    tiles."""
    tiles = -(-S // TILE)
    splits = max(-(-CTAS_PER_SM * sms // (B * KV)),
                 -(-S // max(block_kv, TILE)))
    splits = min(splits, tiles)
    chunk = -(-tiles // splits) * TILE
    return -(-S // chunk), chunk


def flash_decode(q, k, v, t, *, block_kv: int = 1024,
                 use_kernel: bool = False):
    """q: (B, H, hd); k/v: (B, S, KV, hd); t: current length, an int or a
    0-dim int32 tensor (positions >= t are masked; t > S reads the whole
    cache). Returns (B, H, hd) in q's dtype.

    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors. On the card one call is
    a split pass and a combine pass, counted once. ``block_kv`` keeps the
    reference's signature but not its meaning: the kernel's tile is fixed
    at ``TILE`` keys, and ``block_kv`` is the most keys one split reads, so
    it can only raise the split count above what filling the card asks
    for (``split_plan``). The kernel takes hd in ``HEAD_DIMS``, at most
    ``MAX_GROUP`` query heads per KV head, a last dim of stride 1 and k, v
    rows on 16-byte boundaries, and raises on anything else.
    """
    _check(q, k, v, t)
    if not backend.use_kernel(q, require=use_kernel):
        return flash_decode_plain(q, k, v, t)
    B, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash_decode kernel takes head dims "
                         f"{HEAD_DIMS}, got {hd}")
    if G > MAX_GROUP:
        raise ValueError(f"the flash_decode kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head, got {G}")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must have stride 1")
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s % vec for s in x.stride()[:-1]):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries, strides {x.stride()}")
    t_dev, t_host = None, 0
    if torch.is_tensor(t) and t.device == q.device:
        t_dev = t.data_ptr()
    else:
        t_host = max(0, min(int(t), S))
    splits, chunk = split_plan(B, S, KV, block_kv,
                               _sm_count(q.device))
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    m_part = torch.empty((B * KV, splits, G), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B * KV, splits, G, hd), dtype=torch.float32,
                           device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), t_dev, t_host,
                     out.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                     acc_part.data_ptr(), B, S, KV, G, hd, splits, chunk,
                     q.stride(0), q.stride(1), *k.stride()[:3],
                     *v.stride()[:3], hd ** -0.5, _DTYPE_CODE[q.dtype],
                     stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0    # kernel calls so far (not plain calls)
