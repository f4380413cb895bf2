"""Wrapper of the flash-decode kernel (``csrc/flash_decode.cu``).

Takes the layout of ``repro/kernels/flash_decode/ops.py::flash_decode``
(q (B, H, hd); k, v (B, S, KV, hd)) and follows the port's kernel policy
(``kernels/backend.py``): a CPU tensor takes the plain version
(``ref.flash_decode_plain``), a CUDA tensor the compiled kernel or an
error. The kernel reads q, k and v in place with their strides, so the
wrapper transposes nothing, and reads a tensor ``t`` on the device, so a
decode loop never waits on the host.

Per call the wrapper does the checks, two dictionary lookups (the plan
per shape and device, the scratch per device and stream), one
``torch.empty`` for the output and one ctypes call, typed once.
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
TILE = 32                       # keys of a ring stage (the kernel's kTile)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIB = None       # the library, its entry points typed at the first use
_CTAS: dict = {}      # (device, dtype, hd, G) -> CTAs an SM holds
_PLANS: dict = {}     # (device, shape, dtype, block_kv) -> plan
_SCRATCH: dict = {}   # (device, stream) -> (counters, partials)


def _lib():
    global _LIB
    if _LIB is None:
        lib = backend.load(SOURCE)
        lib.flash_decode_ctas_per_sm.argtypes = [ctypes.c_int] * 3
        lib.flash_decode_ctas_per_sm.restype = ctypes.c_int
        lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_int,
                                         ctypes.c_void_p]
        lib.flash_decode_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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


def split_plan(B: int, S: int, KV: int, block_kv: int, sms: int,
               ctas_per_sm: int) -> tuple[int, int]:
    """(splits, chunk) of a cache of S keys for B*KV heads on a card that
    holds ``ctas_per_sm`` CTAs on each of its ``sms`` SMs at once: chunk
    is the most keys a split reads, a whole number of ``TILE``-key tiles
    and at most ``block_kv`` (one tile if ``block_kv`` is smaller); the
    kernel gives each split an even share of the tiles below t. Within
    that bound, the fewest waves of B*KV*splits CTAs, and as many splits
    as fill those waves without starting another one."""
    tiles = -(-S // TILE)
    per_split = max(1, block_kv // TILE)        # tiles a split may read
    slots = ctas_per_sm * sms
    least = -(-tiles // per_split)
    waves = -(-B * KV * least // slots)
    splits = min(max(least, waves * slots // (B * KV)), tiles)
    chunk = -(-tiles // splits)
    return -(-tiles // chunk), chunk * TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(q, k, block_kv: int = 1024) -> dict:
    """The launch a CUDA call on these tensors makes: the kernel's CTAs
    per SM on this card, the splits and keys per split, and the CTAs."""
    splits, chunk = _plan(q, k, block_kv)
    B, S, KV = k.shape[:3]
    key = (q.device, q.dtype, q.shape[2], q.shape[1] // KV)
    return dict(ctas_per_sm=_CTAS[key], sms=_sm_count(q.device),
                splits=splits, chunk=chunk, ctas=B * KV * splits)


def _ctas_per_sm(device, dtype, hd: int, G: int) -> int:
    key = (device, dtype, hd, G)
    if key not in _CTAS:
        with torch.cuda.device(device):
            n = _lib().flash_decode_ctas_per_sm(_DTYPE_CODE[dtype], hd, G)
        if n <= 0:
            raise RuntimeError(f"flash_decode kernel: no CTA fits an SM "
                               f"(CUDA error {-n})")
        _CTAS[key] = n
    return _CTAS[key]


def _plan(q, k, block_kv: int) -> tuple[int, int]:
    """``split_plan`` for this call's shape on its card, cached."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    key = (q.device, B, S, KV, H, hd, q.dtype, block_kv)
    plan = _PLANS.get(key)
    if plan is None:
        ctas = _ctas_per_sm(q.device, q.dtype, hd, H // KV)
        plan = _PLANS[key] = split_plan(B, S, KV, block_kv,
                                        _sm_count(q.device), ctas)
    return plan


def _scratch(device, stream: int, heads: int, n_part: int):
    """(counters, partials) for this device and stream: ``heads`` int32
    counters, zero between calls (the kernel's last CTA of a head resets
    its own), and ``n_part`` fp32 partials, in one allocation that grows
    as calls need and is reused by every later call on the stream."""
    key = (device, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].numel() < heads or held[1].numel() < n_part:
        n_count = max(heads, held[0].numel() if held else 0)
        n_float = max(n_part, held[1].numel() if held else 0)
        pad = -(-n_count // 4) * 4               # partials 16-byte aligned
        buf = torch.zeros(pad + n_float, dtype=torch.int32, device=device)
        held = _SCRATCH[key] = (buf[:n_count], buf[pad:].view(torch.float32))
    return held


def flash_decode(q, k, v, t, *, block_kv: int = 1024,
                 use_kernel: bool = False):
    """q: (B, H, hd); k/v: (B, S, KV, hd); t: current length, an int or a
    0-dim int32 tensor (positions >= t are masked; t > S reads the whole
    cache). Returns (B, H, hd) in q's dtype.

    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors. On the card one call is
    one launch, counted once. ``block_kv`` is the most keys one split
    reads (rounded down to whole ``TILE``-key tiles, at least one): it can
    only raise the split count above what filling the card asks for
    (``split_plan``). The kernel takes hd in ``HEAD_DIMS``, at most
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
    splits, _ = _plan(q, k, block_kv)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    count, part = _scratch(q.device, stream, B * KV,
                           B * KV * splits * G * (hd + 2)
                           if splits > 1 else 0)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    rc = _lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), t_dev, t_host,
        out.data_ptr(), count.data_ptr(), part.data_ptr(), B, S, KV, G, hd,
        splits, q.stride(0), q.stride(1), *k.stride()[:3],
        *v.stride()[:3], hd ** -0.5, _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0    # kernel calls so far (not plain calls)
