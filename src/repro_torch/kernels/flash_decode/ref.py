"""Plain PyTorch versions of the flash-decode kernel.

``flash_decode_plain`` follows the arithmetic of the TPU kernel
(``repro/kernels/flash_decode/kernel.py::_fd_kernel``): q is upcast to
fp32 and scaled by ``hd**-0.5`` in fp32, scores, softmax and the PV
product stay in fp32, a masked score is NEG_INF and its p is 0 after the
exp, the output is ``acc / max(l, 1e-30)`` (so t = 0 gives zeros), and
only the output is cast to q's dtype. The softmax is taken over the
whole cache at once instead of block by block: the same function, with
sums in another order. Positions at or past S do not exist, so t > S
reads the whole cache.

``flash_decode_ref`` is the reference's oracle (``flash_decode/ref.py``)
through the port's ``models/attention._decode_partials`` and
``combine_partials``, with the model's casts: ``q * scale`` in q's dtype
and p in v's dtype before the PV product. This is the same split as
``flash_attention``'s plain version and its reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import _decode_partials, combine_partials

NEG_INF = -1e30


def flash_decode_plain(q, k, v, t):
    """q: (B, H, hd); k/v: (B, S, KV, hd); t: current length (an int or a
    0-dim tensor); query head h reads KV head ``h // (H // KV)``. Returns
    (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, hd) * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float())
    valid = torch.arange(S, device=q.device) < t
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~valid, 0.0)
    o = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    o = o / p.sum(-1).clamp_min(1e-30)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def flash_decode_ref(q, k, v, t):
    """The reference's oracle: q: (B, H, hd); k/v: (B, S, KV, hd)."""
    S = k.shape[1]
    o, l, m = _decode_partials(q, k, v, torch.arange(S, device=q.device), t)
    out = combine_partials(o, l, m, None)
    B, KV, G, hd = out.shape
    return out.reshape(B, KV * G, hd).to(q.dtype)
