"""Carry the reference's weights into the port.

``params_from_numpy`` takes the parameter tree of the reference's
``init_model`` with numpy leaves (``jax.tree.map(np.asarray, params)``)
and builds the port's ``Model``. The reference stacks ``blocks`` on a
leading ``n_scan_blocks`` axis, ``block_pattern`` layers per super-block;
layer ``b * block_pattern + j`` of the port is ``blocks["layer{j}"][b]``.
Leaves keep their ``(in, out)`` layout, so carrying them is a copy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model, _check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16, as JAX gives it
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> Model:
    """The reference's parameter tree (numpy leaves) as the port's model
    on ``device`` (cuda unless given)."""
    _check_supported(cfg)
    device = resolve_device(device)
    out = {k: _tensor(tree[k], device) for k in ("embed_tokens", "lm_head")
           if k in tree}
    out["blocks"] = [
        {sub: {leaf: _tensor(a[b], device) for leaf, a in leaves.items()}
         for sub, leaves in tree["blocks"][f"layer{j}"].items()}
        for b in range(cfg.n_scan_blocks) for j in range(cfg.block_pattern)]
    out["final_norm"] = {k: _tensor(a, device)
                         for k, a in tree["final_norm"].items()}
    return Model(out)
