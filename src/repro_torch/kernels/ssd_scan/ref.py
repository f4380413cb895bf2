"""Plain PyTorch version of the ssd_scan kernel.

It follows the arithmetic of the TPU kernel
(``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``), not the model's
``ssd_ref`` with its input-dtype ``x * dt``: every operand is cast to
fp32 and ``x * dt`` is taken in fp32. Per chunk, carrying the (P, N)
state chunk by chunk:

  cum   = cumsum(dt * A) within the chunk
  L     = where(i >= j, exp(cum_i - cum_j), 0)      (select: the exp
                                                     overflows for i < j)
  y     = (C Bᵀ ∘ L)(x·dt) + (C stateᵀ)·exp(cum)    (the state before
                                                     this chunk's update)
  state = state·exp(cum_last) + (x·dt·exp(cum_last - cum))ᵀ B

y is cast to x's dtype at the end; the state stays fp32. Head h reads
group ``h // (H // G)`` of B and C. A last chunk shorter than ``chunk``
is the TPU kernel's zero padding left out (dt = 0 rows are a no-op).
"""
from __future__ import annotations

import torch


def ssd_plain(x, dt, A, B, C, *, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B/C: (B, S, G, N).
    Returns (y (B, S, H, P) in x's dtype, state (B, H, P, N) fp32)."""
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    chunk = min(chunk, S)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bh = B.float().repeat_interleave(rep, dim=2)         # (B,S,H,N)
    Ch = C.float().repeat_interleave(rep, dim=2)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    state = torch.zeros((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        n = c1 - c0
        xc = xf[:, c0:c1].transpose(1, 2)                # (B,H,n,P)
        dtc = dtf[:, c0:c1].transpose(1, 2)              # (B,H,n)
        Bc = Bh[:, c0:c1].transpose(1, 2)                # (B,H,n,N)
        Cc = Ch[:, c0:c1].transpose(1, 2)
        cum = torch.cumsum(dtc * Af[None, :, None], -1)
        L = torch.where(causal[:n, :n],
                        torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        s = (Cc @ Bc.transpose(-1, -2)) * L
        xdt = xc * dtc[..., None]
        yc = s @ xdt
        yc = yc + (Cc @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        y[:, c0:c1] = yc.transpose(1, 2).to(x.dtype)
        last = cum[..., -1:]
        upd = (xdt * torch.exp(last - cum)[..., None]).transpose(-1, -2) @ Bc
        state = state * torch.exp(last)[..., None] + upd
    return y, state


def fold_init_state(y, state, dt, A, C, init_state):
    """Add a carried-in ``init_state`` (B, H, P, N) to a scan run from
    zero, in the closed form of the reference wrapper
    (``repro/kernels/ssd_scan/ops.py``): y_t += C_t · (init ·
    exp(cum_t)) with cum the cumsum of dt·A over the whole sequence,
    added in y's dtype; state += init · exp(cum_S)."""
    H, G = dt.shape[2], C.shape[2]
    cum = torch.cumsum(dt.float() * A.float()[None, None, :], 1)   # (B,S,H)
    Chh = C.float().repeat_interleave(H // G, dim=2)               # (B,S,H,N)
    init = init_state.float()
    y_init = torch.einsum("bshn,bhpn,bsh->bshp", Chh, init, torch.exp(cum))
    y = y + y_init.to(y.dtype)
    state = state + init * torch.exp(cum[:, -1])[:, :, None, None]
    return y, state
