"""Wrapper of the wordcount histogram kernel (``csrc/hist.cu``).

The counterpart of ``repro/kernels/wordcount_hash/ops.py``. Follows the
port's kernel policy (``kernels/backend.py``): a CPU tensor takes the
plain version (``ref.hist_plain``), a CUDA tensor the compiled kernel or
an error. ``wordcount_hist_ref`` is the reference's oracle, with its
index normalisation of negative keys (``ref.hist_ref``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.wordcount_hash.ref import hist_plain, hist_ref

SOURCE = Path(__file__).parent / "csrc" / "hist.cu"

_FN = None    # the typed C entry point, resolved at the first launch


def _launcher():
    global _FN
    if _FN is None:
        fn = backend.load(SOURCE).hist_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(tokens, vocab: int, hash_mod: int):
    if tokens.dim() != 1 or tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be (N,) int32, got {tuple(tokens.shape)}"
                        f" {tokens.dtype}")
    if not 1 <= vocab < 2**31 or not 0 <= hash_mod < 2**31:
        raise ValueError(f"need 1 <= vocab < 2**31 and 0 <= hash_mod < "
                         f"2**31, got vocab={vocab}, hash_mod={hash_mod}")


def wordcount_hist(tokens, vocab: int, hash_mod: int = 0, *,
                   use_kernel: bool = False):
    """tokens: (N,) int32 (SENTINEL = skip). Returns (vocab,) int32 counts
    of each token (``hash_mod=0``) or of ``mix32(token) % hash_mod`` (owner
    mode); keys outside ``[0, vocab)`` are dropped.

    The tensor's device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on a CPU tensor. On the card the kernel
    takes contiguous tokens and raises on anything else.
    """
    _check(tokens, vocab, hash_mod)
    if not backend.use_kernel(tokens, require=use_kernel):
        return hist_plain(tokens, vocab, hash_mod=hash_mod)
    if not tokens.is_contiguous():
        raise ValueError("tokens must be contiguous")
    out = torch.zeros((vocab,), dtype=torch.int32, device=tokens.device)
    if tokens.numel() == 0:
        return out
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    rc = _launcher()(tokens.data_ptr(), tokens.numel(), out.data_ptr(),
                     vocab, hash_mod, stream)
    if rc != 0:
        raise RuntimeError(f"hist kernel launch failed: CUDA error {rc}")
    wordcount_hist.launches += 1
    return out


wordcount_hist.launches = 0    # kernel launches so far (not plain calls)


def wordcount_hist_ref(tokens, vocab: int, hash_mod: int = 0):
    """The reference's oracle on any device (plain PyTorch)."""
    _check(tokens, vocab, hash_mod)
    return hist_ref(tokens, vocab, hash_mod=hash_mod)
