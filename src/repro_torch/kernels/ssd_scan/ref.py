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

``ssd_chunked_plain`` computes the same function as the bf16 kernel's
three passes do (each chunk's state from zero, the chain of entering
states, the outputs); only the tests call it.
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


def ssd_chunked_plain(x, dt, A, B, C, *, chunk: int = 256):
    """The bf16 kernel's three passes (``csrc/ssd_scan_bf16.cu``) in torch
    on fp32, for the tests: the published Mamba-2 chunk decomposition of
    ``ssd_plain``'s function. With cum the cumsum of dt·A within each
    chunk and last_c its value at the chunk's last row:

      (a) U_c   = (x·dt·exp(last_c - cum))ᵀ B       each chunk from zero
      (b) S_in  = 0, then S_in[c] = S_in[c-1]·exp(last_{c-1}) + U_{c-1};
                  the final state is the same step past the last chunk
      (c) y     = (C Bᵀ ∘ L ∘ dt_j) x + exp(cum)·(C S_inᵀ)

    Rows past S are dt = 0 and zeros, as the kernel reads them. Same
    arguments and returns as ``ssd_plain``."""
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    n_c = -(-S // chunk)
    pad = n_c * chunk - S

    def chunks(t):            # (B, S, H, k) -> (B, H, n_c, chunk, k)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(Bb, n_c, chunk, H, -1).permute(0, 3, 1, 2, 4)

    xc = chunks(x)
    Bc = chunks(B.repeat_interleave(H // G, dim=2))
    Cc = chunks(C.repeat_interleave(H // G, dim=2))
    dtc = chunks(dt[..., None])[..., 0]                   # (B,H,n_c,chunk)
    cum = torch.cumsum(dtc * A.float()[None, :, None, None], -1)
    last = cum[..., -1]                                   # (B,H,n_c)
    # (a)
    w = dtc * torch.exp(last[..., None] - cum)
    U = (xc * w[..., None]).transpose(-1, -2) @ Bc        # (B,H,n_c,P,N)
    # (b)
    S_in = torch.empty_like(U)
    state = torch.zeros_like(U[:, :, 0])
    for c in range(n_c):
        S_in[:, :, c] = state
        state = state * torch.exp(last[:, :, c])[..., None, None] + U[:, :, c]
    # (c)
    ii = torch.arange(chunk, device=x.device)
    decay = torch.where(ii[:, None] >= ii[None, :],
                        torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    M = (Cc @ Bc.transpose(-1, -2)) * decay * dtc[..., None, :]
    y = M @ xc + torch.exp(cum)[..., None] * (Cc @ S_in.transpose(-1, -2))
    y = y.permute(0, 2, 3, 1, 4).reshape(Bb, n_c * chunk, H, Pd)[:, :S]
    return y.to(x.dtype), state


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
