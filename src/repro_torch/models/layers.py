"""Shared layer primitives: norms, RoPE, SwiGLU MLP, embeddings, the
LM loss.

The counterpart of ``repro/models/layers.py``. ``init_*`` builds a dict
of tensors under the reference's leaf names from an explicit
``torch.Generator``; ``apply_*`` consumes any mapping with those names
(a dict or the ``nn.ParameterDict`` the model holds). Weights keep the
reference's ``(in, out)`` layout, so ``x @ w`` is the same product.
Where an fp32 activation meets a bf16 weight (whisper's fp32 frames and
encoder output), ``matmul`` promotes as JAX does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under JAX's type promotion: bf16 against fp32 runs in
    fp32 (torch's ``@`` refuses mixed dtypes). bf16 -> fp32 is exact, so
    this is the reference's arithmetic."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the ``init_*``
    functions make their tensors on ``gen.device``, and on ``meta``
    (shapes and dtypes, no data; the dry run's) ``torch.randn`` takes a
    CPU generator and draws nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The ``init_*`` functions' generator on ``device``, seeded."""
    if device.type == "meta":
        return _MetaGenerator().manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def _init(gen: torch.Generator, shape, scale, dtype):
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    if cfg.norm_type == "nonparam_ln":      # OLMo: no scale/bias
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype_of(cfg),
                                device=gen.device)}


def apply_norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (population variance) or RMSNorm, in fp32."""
    xf = x.float()
    if cfg.norm_type in ("layernorm", "nonparam_ln"):
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
    else:                                    # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps)
    if "scale" in p:
        y = y * p["scale"].float()
    return y.to(x.dtype)


def rms_over(x, scale, eps=1e-5):
    """RMS norm over the last dim with an explicit scale vector (qk-norm)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Split-half rotation. x: (..., S, dim); positions: (..., S) int;
    angles in fp32."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)               # (dim/2,)
    angles = positions[..., None].float() * freqs          # (..., S, dim/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int = 0) -> dict:
    d, ff = cfg.d_model, (d_ff or cfg.d_ff)
    dt = DTYPES[cfg.param_dtype]
    return {
        "w_gate": _init(gen, (d, ff), d ** -0.5, dt),
        "w_in": _init(gen, (d, ff), d ** -0.5, dt),
        "w_out": _init(gen, (ff, d), ff ** -0.5, dt),
    }


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(matmul(x, p["w_gate"]))
    h = matmul(x, p["w_in"])
    return matmul(g * h, p["w_out"])


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embed(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = DTYPES[cfg.param_dtype]
    p = {"embed_tokens": _init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _init(gen, (cfg.d_model, cfg.vocab_size),
                             cfg.d_model ** -0.5, dt)
    return p


def embed_tokens(cfg: ModelConfig, p, tokens: torch.Tensor):
    return p["embed_tokens"][tokens]


def unembed(cfg: ModelConfig, p, x: torch.Tensor):
    """Logits in the model dtype; tied embeddings give ``x @ embed.T``."""
    if cfg.tie_embeddings:
        return x @ p["embed_tokens"].t()
    return x @ p["lm_head"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor = None) -> torch.Tensor:
    """Token-mean CE in fp32; with ``mask``, the mean over the masked-in
    tokens (a mask of zeros gives 0)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / mask.sum().clamp_min(1)
