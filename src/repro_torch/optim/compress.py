"""int8 gradient compression with fp32 error feedback (counterpart of
``repro/optim/compress.py``).

Per-leaf symmetric int8 quantization; the residual stays local and is
added back at the next step, which keeps the quantization's bias out of
the long-run gradient estimate. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes equal the reference's.
"""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor):
    """x (fp) -> (int8 codes, fp32 scale). Symmetric, per tensor."""
    xf = x.float()
    scale = xf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ef_compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """One error-feedback round: (decompressed g_hat, new residual).
    g_hat is what crosses the wire (int8 and one scale); the residual
    ``g - g_hat`` is folded into the next step's gradient."""
    g_corr = g.float() + residual
    q, scale = compress_int8(g_corr)
    g_hat = decompress_int8(q, scale)
    return g_hat.to(g.dtype), g_corr - g_hat


def ef_compress(grads, residuals):
    """Lists of tensors in, lists out: (g_hat, new residuals)."""
    outs = [ef_compress_leaf(g, r) for g, r in zip(grads, residuals)]
    return [o[0] for o in outs], [o[1] for o in outs]


def init_residuals(params):
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]
