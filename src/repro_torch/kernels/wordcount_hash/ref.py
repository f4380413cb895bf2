"""Plain PyTorch versions of the wordcount histogram kernel.

``hist_plain`` follows the TPU kernel
(``repro/kernels/wordcount_hash/kernel.py::_hist_kernel``), which is
what the reference's ``wordcount_hist`` runs: a SENTINEL token is
skipped, the key is the token itself or, in owner mode
(``hash_mod > 0``), ``mix32(token) % hash_mod`` in uint32, and a key
outside ``[0, vocab)`` is dropped (the kernel compares keys against the
ids of its vocab tiles only).

``hist_ref`` is the reference's oracle (``wordcount_hash/ref.py::
hist_ref``) as written: a scatter-add into ``vocab + 1`` slots with
NumPy-style index normalisation, so a key k in ``[-(vocab + 1), 0)``
lands on slot ``vocab + 1 + k`` (k = -2 counts as ``vocab - 1``) where
the kernel drops it. The two agree on every key in ``[0, vocab)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.kv import KEY_SENTINEL, mix32


def _keys(tokens: torch.Tensor, hash_mod: int) -> torch.Tensor:
    """Each token's key as int64: the token, or mix32(token) % hash_mod."""
    if hash_mod > 0:
        return mix32(tokens) % hash_mod
    return tokens.to(torch.int64)


def hist_plain(tokens: torch.Tensor, vocab: int, *, hash_mod: int = 0
               ) -> torch.Tensor:
    """tokens: (N,) int32 (SENTINEL = skip). Returns (vocab,) int32 counts
    of each key in ``[0, vocab)``; other keys are dropped."""
    keys = _keys(tokens, hash_mod)
    keep = (tokens != KEY_SENTINEL) & (keys >= 0) & (keys < vocab)
    return torch.bincount(keys[keep], minlength=vocab).to(torch.int32)


def hist_ref(tokens: torch.Tensor, vocab: int, *, hash_mod: int = 0
             ) -> torch.Tensor:
    """The reference oracle: SENTINELs go to the ghost slot ``vocab``, a
    negative key is normalised by ``vocab + 1``, and what is still out
    of ``[0, vocab + 1)`` is dropped, as JAX's scatter drops it."""
    keys = torch.where(tokens != KEY_SENTINEL, _keys(tokens, hash_mod),
                       vocab)
    keys = torch.where(keys < 0, keys + vocab + 1, keys)
    keys = keys[(keys >= 0) & (keys <= vocab)]
    return torch.bincount(keys, minlength=vocab + 1)[:vocab].to(torch.int32)
