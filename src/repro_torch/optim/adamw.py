"""AdamW (counterpart of ``repro/optim/adamw.py``).

The reference's arithmetic, in its order: clip by the global norm (or
only report it when ``grad_clip <= 0``), ``step + 1``, the warmup-cosine
``lr_schedule``, fp32 bias corrections, ``delta = mhat / (sqrt(vhat) +
eps) + wd * p`` in fp32, ``p - lr * delta`` cast back to the parameter's
dtype, the moments stored in ``moment_dtype``. ``torch.optim.AdamW`` is
another computation (its decay is applied apart from the step, and it
keeps its own step counter), so it is not used.

Parameters, gradients and moments are lists of tensors in one order
(``model.parameters()``'s in the train state). The step counter is a
0-d int32 tensor on the parameters' device, so no step reads it back to
the host. ``adamw_update`` writes the parameters, the moments and the
counter in place (the reference's train step donates its state to the
same end)
and runs the elementwise passes with ``torch._foreach_*`` over groups of
leaves, so the fp32 temporaries stay bounded.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.layers import DTYPES

# elements in one group of leaves: each fp32 temporary of a group is at
# most 256 MB (a bigger leaf is a group of its own)
GROUP_NUMEL = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-d int32
    mu: list                     # first moment, one tensor a parameter
    nu: list                     # second moment


def adamw_init(params, cfg: TrainConfig) -> AdamWState:
    params = list(params)
    mdt = DTYPES[cfg.moment_dtype]
    device = params[0].device

    def zeros():
        return [torch.zeros(p.shape, dtype=mdt, device=p.device)
                for p in params]
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      zeros(), zeros())


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10 %, in fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tensors) -> torch.Tensor:
    return torch.stack([x.float().square().sum() for x in tensors]) \
        .sum().sqrt()


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm);
    the scale is cast to each gradient's dtype before the product."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
    return [g * scale.to(g.dtype) for g in grads], norm


def _groups(tensors):
    group, n = [], 0
    for i, t in enumerate(tensors):
        if group and n + t.numel() > GROUP_NUMEL:
            yield group
            group, n = [], 0
        group.append(i)
        n += t.numel()
    if group:
        yield group


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: TrainConfig):
    """Returns (params, state, {"grad_norm", "lr"}). ``grad_clip <= 0``
    disables clipping (but still reports the norm). ``params``, the
    moments and the step counter are updated in place."""
    params, grads = list(params), list(grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step.add_(1)
    lr = lr_schedule(cfg, step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def f32(ts):
        return [t.float() for t in ts]

    for idx in _groups(params):
        p = [params[i] for i in idx]
        m = [state.mu[i] for i in idx]
        v = [state.nu[i] for i in idx]
        g = f32(grads[i] for i in idx)
        mf = torch._foreach_add(torch._foreach_mul(f32(m), b1),
                                torch._foreach_mul(g, 1 - b1))
        vf = torch._foreach_add(
            torch._foreach_mul(f32(v), b2),
            torch._foreach_mul(torch._foreach_mul(g, 1 - b2), g))
        del g
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(vf, bc2)), eps)
        delta = torch._foreach_div(torch._foreach_div(mf, bc1), denom)
        del denom
        pf = f32(p)
        delta = torch._foreach_add(delta, torch._foreach_mul(pf, wd))
        new_p = torch._foreach_sub(pf, torch._foreach_mul(delta, lr))
        del pf, delta
        for dst, src in zip(p + m + v, new_p + mf + vf):
            dst.copy_(src)
    return params, state, {"grad_norm": gnorm, "lr": lr}
