"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060
(counterpart of ``repro/models/ssm.py``).

Chunked SSD algorithm: within a chunk the recurrence is a masked
(attention-like) quadratic form; across chunks a linear pass carries the
(H, P, N) states.

Shapes (SSD convention):
  x   (B, S, H, P)   P = head dim
  dt  (B, S, H)      softplus-activated step sizes
  A   (H,)           negative decay rate (from A_log), fp32
  B,C (B, S, G, N)   G groups, N = ssm_state
  y   (B, S, H, P)

``ssd_ref`` is the chunked oracle with the reference's dtype behaviour
(``x * dt`` rounds in the input dtype, products accumulate in fp32).
``ssm_forward(use_kernel=True)`` runs the ``ssd_scan`` kernel's wrapper
instead: the kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import DTYPES, _init, rms_over


# The two activations are written op by op as the reference's CPU build
# computes them, rounding in the input dtype after each op: in bf16 the
# fused ``F.softplus``/``F.silu`` (one rounding) differ from it in a third
# of the elements, and 48 layers carry that gap into the logits.

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|)), with no linear cut-over above a threshold
    (``F.softplus`` has one at 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` = x * sigmoid(x), the sigmoid as 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


# ---------------------------------------------------------------------------
# core SSD math
# ---------------------------------------------------------------------------

def ssd_ref(x, dt, A, B, C, *, chunk: int = 256, init_state=None):
    """Chunked SSD. Returns (y in x's dtype, final_state (B,H,P,N) fp32).

    S need not divide the chunk: the last chunk is shorter (the
    reference zero-pads it, and dt = 0 padding is a no-op on the
    recurrence). The reference's ``lax.scan`` over chunks is a loop."""
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    assert H % G == 0
    chunk = min(chunk, S)
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2)                 # (B,S,H,N)
    Ch = C.repeat_interleave(rep, dim=2)
    A = A.float()
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    state = (torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        n = c1 - c0
        xc = x[:, c0:c1].transpose(1, 2)                 # (B,H,n,P)
        dtc = dt[:, c0:c1].transpose(1, 2)               # (B,H,n)
        Bc = Bh[:, c0:c1].transpose(1, 2).float()        # (B,H,n,N)
        Cc = Ch[:, c0:c1].transpose(1, 2).float()
        cum = torch.cumsum(dtc * A[None, :, None], -1)   # fp32, negative
        # L[i,j] = exp(cum_i - cum_j) for i >= j. Above the diagonal the
        # difference is positive and its exp can overflow: select -inf
        # before the exp (exp gives 0), so that the backward pass does not
        # multiply a zero gradient by inf
        L = torch.exp(torch.where(causal[:n, :n],
                                  cum[..., :, None] - cum[..., None, :],
                                  -torch.inf))
        s = (Cc @ Bc.transpose(-1, -2)) * L              # (B,H,i,j)
        xdt = (xc * dtc[..., None]).float()              # rounds in x's dtype
        y = s @ xdt
        # carried-in state: the state before this chunk's update
        y = y + (Cc @ state.transpose(-1, -2)) * torch.exp(cum)[..., None]
        ys.append(y.transpose(1, 2))
        last = cum[..., -1:]
        upd = (xdt * torch.exp(last - cum)[..., None]).transpose(-1, -2) @ Bc
        state = state * torch.exp(last)[..., None] + upd
    return torch.cat(ys, 1).to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrence. state: (B,H,P,N); x_t: (B,H,P);
    dt_t: (B,H); B_t/C_t: (B,G,N)."""
    H = x_t.shape[1]
    G = B_t.shape[1]
    rep = H // G
    Bh = B_t.repeat_interleave(rep, dim=1)               # (B,H,N)
    Ch = C_t.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt_t * A[None, :])[..., None, None]   # (B,H,1,1) fp32
    upd = (dt_t[..., None] * x_t)[..., None] * Bh[:, :, None, :]
    state = state * dA + upd                             # (B,H,P,N) fp32
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.float())
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# the full block (projections, conv, gating)
# ---------------------------------------------------------------------------

def init_ssm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """The reference's leaves, in its ``(in, out)`` layouts, drawn from
    ``gen``."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, K = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    H = cfg.n_ssm_heads
    dt = DTYPES[cfg.param_dtype]
    s = d ** -0.5

    def const(v):
        return torch.full((H,), v, dtype=dt, device=gen.device)
    return {
        "w_z": _init(gen, (d, di), s, dt),
        "w_x": _init(gen, (d, di), s, dt),
        "w_B": _init(gen, (d, G * N), s, dt),
        "w_C": _init(gen, (d, G * N), s, dt),
        "w_dt": _init(gen, (d, H), s, dt),
        "dt_bias": const(0.0),
        "conv_x": _init(gen, (K, di), K ** -0.5, dt),
        "conv_B": _init(gen, (K, G * N), K ** -0.5, dt),
        "conv_C": _init(gen, (K, G * N), K ** -0.5, dt),
        "A_log": const(0.0),                 # A = -exp(A_log) = -1
        "D_skip": const(1.0),
        "gate_norm": torch.ones((di,), dtype=dt, device=gen.device),
        "w_out": _init(gen, (di, d), di ** -0.5, dt),
    }


def _causal_conv(u, w, carry=None):
    """Depthwise causal conv. u: (B, S, C); w: (K, C). carry: (B, K-1, C),
    the last K-1 pre-activation inputs. The taps are summed in order,
    rounding in u's dtype after each add, as the reference's ``sum``."""
    K = w.shape[0]
    if carry is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = carry.to(u.dtype)
    up = torch.cat([pad, u], 1)
    S = u.shape[1]
    out = up[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + up[:, i:i + S] * w[i]
    # a copy: a view would keep all of ``up`` (B, S + K - 1, C) alive for
    # as long as the cache holds the carry
    new_carry = up[:, -(K - 1):].clone() if K > 1 else pad
    return silu(out), new_carry


def _project(cfg: ModelConfig, p, x, conv_carry):
    """The block's input side: z, the conv'd x/B/C, dt and A."""
    z = x @ p["w_z"]
    u = x @ p["w_x"]
    Bp = x @ p["w_B"]
    Cp = x @ p["w_C"]
    dt = softplus((x @ p["w_dt"]) + p["dt_bias"])
    cc = conv_carry or {}
    u, cx = _causal_conv(u, p["conv_x"], cc.get("conv_x"))
    Bp, cb = _causal_conv(Bp, p["conv_B"], cc.get("conv_B"))
    Cp, cC = _causal_conv(Cp, p["conv_C"], cc.get("conv_C"))
    A = -torch.exp(p["A_log"].float())
    return z, u, Bp, Cp, dt, A, {"conv_x": cx, "conv_B": cb, "conv_C": cC}


def _gate_out(cfg: ModelConfig, p, y, xh, z):
    """D skip, gated RMS norm and the output projection."""
    y = y + xh * p["D_skip"][:, None].to(y.dtype)
    y = y.reshape(*z.shape[:-1], cfg.d_inner)
    y = rms_over(y * silu(z), p["gate_norm"])
    return y @ p["w_out"]


def ssm_forward(cfg: ModelConfig, p, x, *, use_kernel=False,
                init_state=None, conv_carry=None):
    """x: (B, S, D) -> (B, S, D), cache {"state","conv_x","conv_B","conv_C"}.

    ``use_kernel=True`` scans through ``kernels/ssd_scan/ops.ssd`` (the
    kernel on the card, its plain version on the CPU), else ``ssd_ref``.
    """
    B_, S, _ = x.shape
    H, Pd = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, u, Bp, Cp, dt, A, conv = _project(cfg, p, x, conv_carry)
    xh = u.reshape(B_, S, H, Pd)
    args = (xh, dt, A, Bp.reshape(B_, S, G, N), Cp.reshape(B_, S, G, N))
    if use_kernel:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        y, state = ssd_ops.ssd(*args, chunk=cfg.ssm_chunk,
                               init_state=init_state)
    else:
        y, state = ssd_ref(*args, chunk=cfg.ssm_chunk, init_state=init_state)
    return _gate_out(cfg, p, y, xh, z), {"state": state, **conv}


def ssm_decode(cfg: ModelConfig, p, x, cache: dict):
    """One-token step. x: (B, 1, D)."""
    B_ = x.shape[0]
    H, Pd = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state
    z, u, Bp, Cp, dt, A, conv = _project(cfg, p, x, cache)
    xh = u[:, 0].reshape(B_, H, Pd)
    y, state = ssd_decode_step(cache["state"], xh, dt[:, 0], A,
                               Bp[:, 0].reshape(B_, G, N),
                               Cp[:, 0].reshape(B_, G, N))
    return _gate_out(cfg, p, y, xh, z), {"state": state, **conv}
