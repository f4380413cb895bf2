"""Carry weights between the reference's parameter tree and the port.

``params_from_numpy`` takes the parameter tree of the reference's
``init_model`` with numpy leaves (``jax.tree.map(np.asarray, params)``)
and builds the port's ``Model``; ``params_to_numpy`` is its inverse. The
reference keeps its ``first_k_dense`` leading layers apart, layer ``i``
under ``dense_layers["layer{i}"]``, and stacks ``blocks`` on a leading
``n_scan_blocks`` axis, ``block_pattern`` layers per super-block; layer
``first_k_dense + b * block_pattern + j`` of the port is
``blocks["layer{j}"][b]``. An encoder's layers are stacked on a leading
``n_enc_layers`` axis under ``enc_blocks["layer0"]``: encoder layer ``i``
of the port is ``enc_blocks["layer0"][i]``. Leaves keep their ``(in,
out)`` layout, so carrying them is a copy.

``ref_tree`` and ``ref_leaves`` do the same for any tensors that line up
with a model's parameters (gradients, AdamW's moments): the train
state's snapshot uses them to write and read the reference's leaf keys.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Model, _check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                         # a writable, contiguous copy
    # ml_dtypes' bf16, as JAX gives it, or its bit patterns as
    # ``params_to_numpy`` gives them
    if a.dtype.name in ("bfloat16", "uint16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _ref_layer(cfg: ModelConfig, i: int,
               top: str = "blocks") -> tuple[str, str, int | None]:
    """Where port layer ``i`` of ``top`` ("blocks" or "enc_blocks") sits
    in the reference's tree: (subtree, layer key, block index), the block
    index None for a leading dense layer."""
    if top == "enc_blocks":
        return top, "layer0", i
    first, bp = cfg.first_k_dense, cfg.block_pattern
    if i < first:
        return "dense_layers", f"layer{i}", None
    return "blocks", f"layer{(i - first) % bp}", (i - first) // bp


_STACKS = ("blocks", "enc_blocks")


def ref_tree(cfg: ModelConfig, named, stack=torch.stack) -> dict:
    """The reference's tree of ``named``, pairs of a ``Model`` parameter
    name (``model.named_parameters()``: ``embed_tokens``,
    ``blocks.3.attn.wq``, ``final_norm.scale``, ...) and a tensor of that
    parameter's shape. ``stack`` joins the ``n_scan_blocks`` tensors of
    each ``blocks/layer{j}`` leaf, in block order (and the
    ``n_enc_layers`` tensors of each ``enc_blocks/layer0`` leaf); a
    leading dense layer's leaves go under ``dense_layers/layer{i}`` as
    they are."""
    tree, stacked = {}, {}
    for name, t in named:
        parts = name.split(".")
        if parts[0] in _STACKS:
            i, sub, leaf = int(parts[1]), parts[2], parts[3]
            top, layer, b = _ref_layer(cfg, i, parts[0])
            if b is None:
                tree.setdefault(top, {}).setdefault(layer, {}) \
                    .setdefault(sub, {})[leaf] = t
            else:
                stacked.setdefault((top, layer, sub, leaf), []).append(t)
        else:
            node = tree
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = t
    tree["blocks"] = {}
    for (top, layer, sub, leaf), ts in stacked.items():
        tree.setdefault(top, {}).setdefault(layer, {}) \
            .setdefault(sub, {})[leaf] = stack(ts)
    return tree


def ref_leaves(cfg: ModelConfig, tree: dict, names) -> list:
    """The inverse of ``ref_tree``: for each parameter name, its tensor
    in ``tree`` (a block leaf's slice for that layer)."""
    out = []
    for name in names:
        parts = name.split(".")
        if parts[0] in _STACKS:
            i, sub, leaf = int(parts[1]), parts[2], parts[3]
            top, layer, b = _ref_layer(cfg, i, parts[0])
            t = tree[top][layer][sub][leaf]
            out.append(t if b is None else t[b])
        else:
            node = tree
            for k in parts:
                node = node[k]
            out.append(node)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; bf16 as its raw 16-bit patterns (``np.uint16``): the
    card's host need not have ``ml_dtypes``."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_to_numpy(cfg: ModelConfig, model: Model, leaves=None) -> dict:
    """The inverse of ``params_from_numpy``: the model's parameters as
    the reference's tree with numpy leaves, blocks stacked to
    ``(n_scan_blocks, ...)``; a bf16 leaf as ``np.uint16`` bit patterns.
    ``leaves``, tensors in the order of ``model.parameters()``
    (gradients, moments), are converted in the parameters' place."""
    names = [n for n, _ in model.named_parameters()]
    if leaves is None:
        leaves = [p.detach() for p in model.parameters()]
    tree = ref_tree(cfg, zip(names, leaves))
    # a norm without parameters (OLMo's) is an empty dict, as there
    tree.setdefault("final_norm", {})
    if "enc_norm" in model:
        tree.setdefault("enc_norm", {})
    for stack in _STACKS:
        for i, layer in enumerate(getattr(model, stack, ())):
            top, key, _ = _ref_layer(cfg, i, stack)
            node = tree.setdefault(top, {}).setdefault(key, {})
            for sub in layer:
                node.setdefault(sub, {})
    return _map(tree, _numpy)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> Model:
    """The reference's parameter tree (numpy leaves) as the port's model
    on ``device`` (cuda unless given)."""
    _check_supported(cfg)
    device = resolve_device(device)
    out = {k: _tensor(tree[k], device) for k in ("embed_tokens", "lm_head")
           if k in tree}
    for stack, n in (("blocks", cfg.n_layers),
                     ("enc_blocks", cfg.n_enc_layers)):
        if stack not in tree:
            continue
        out[stack] = []
        for i in range(n):
            top, key, b = _ref_layer(cfg, i, stack)
            out[stack].append(
                {sub: {leaf: _tensor(a if b is None else a[b], device)
                       for leaf, a in leaves.items()}
                 for sub, leaves in tree[top][key].items()})
    for norm in ("enc_norm", "final_norm"):
        if norm in tree:
            out[norm] = {k: _tensor(a, device)
                         for k, a in tree[norm].items()}
    return Model(out)
