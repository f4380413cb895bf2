"""Plain PyTorch version of the flash_attention kernel.

It follows the arithmetic of the TPU kernel
(``repro/kernels/flash_attention/kernel.py::_fa_kernel``), not the
model's chunked ``flash_attention_ref`` with its bf16 casts: q, k and v
are upcast to fp32, q is scaled by ``hd**-0.5`` in fp32, scores, softmax
and the PV product stay in fp32, and only the output is cast back to q's
dtype. A masked entry gets NEG_INF before the row max and p = 0 after
the exp, so a row with no visible key comes out as 0 (``acc / max(l,
1e-30)`` with acc = l = 0). Each row's softmax is taken over its whole
key range at once instead of tile by tile: the same function, with sums
taken in another order than the kernel's.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
ROWS = 512      # query rows per pass: bounds the (B, KV, G, ROWS, Skv) scores


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, Skv, KV, hd) with H % KV == 0; query
    head h reads KV head ``h // (H // KV)``. ``window > 0`` keeps keys
    with ``k_pos > q_pos - window``. Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty_like(q)
    for lo in range(0, Sq, ROWS):
        hi = min(Sq, lo + ROWS)
        qf = q[:, lo:hi].float().reshape(B, hi - lo, KV, G, hd) * hd ** -0.5
        s = torch.einsum("bqkgh,bckh->bkgqc", qf, kf)
        q_pos = torch.arange(lo, hi, device=q.device)[:, None]
        mask = torch.ones((hi - lo, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window > 0:
            mask &= k_pos > q_pos - window
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~mask, 0.0)
        o = torch.einsum("bkgqc,bckh->bkgqh", p, vf)
        o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(B, hi - lo, H, hd)
    return out
