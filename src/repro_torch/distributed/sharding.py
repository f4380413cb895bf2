"""Logical -> mesh sharding rules (counterpart of
``repro/distributed/sharding.py``).

``param_specs`` assigns a spec to every parameter by its leaf name, as
the reference's does:

  * Megatron TP over the ``"model"`` axis on head / d_ff / vocab / expert
    dims, only when the dim divides by tp (a GQA arch with kv_heads < tp
    shards q/o on heads and replicates k/v);
  * FSDP over the ``"data"`` axis on one remaining dim of every matrix,
    when it divides; the pod axis replicates;
  * a scan-stacked leaf of the reference's tree (under ``blocks`` or
    ``enc_blocks``) gets a leading ``None`` for its layer dim.

``P`` is the port's ``PartitionSpec``: a tuple of entries, each None, an
axis name or a tuple of names (major to minor). On one card a sharding
is a spec, not a placement: ``collectives.shard_map`` blocks operands by
it, and ``shard_params`` returns the parameters as they are.
"""
from __future__ import annotations

from typing import Any

from repro_torch.config import MeshConfig, ModelConfig


class P(tuple):
    """``PartitionSpec(*entries)`` as a tuple: ``P("data", None) ==
    ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _divisible(dim: int, by: int) -> bool:
    return by > 0 and dim % by == 0


def _dp_entry(mesh_cfg: MeshConfig):
    axes = mesh_cfg.dp_axes
    return axes[0] if len(axes) == 1 else tuple(axes)


def _fsdp_axis(mesh_cfg: MeshConfig) -> str:
    return "data"


def _fsdp_size(mesh_cfg: MeshConfig) -> int:
    for s, a in zip(mesh_cfg.shape, mesh_cfg.axes):
        if a == "data":
            return s
    return 1


# --------------------------------------------------------------------------
# per-leaf rule
# --------------------------------------------------------------------------

def _leaf_spec(name: str, shape, cfg: ModelConfig, mesh_cfg: MeshConfig,
               variant: str = "default") -> P:
    """Spec for an *unstacked* leaf (no leading scan dim).

    variants:
      default  Megatron TP over "model" + FSDP over "data"
      flat_dp  no TP: pure FSDP with params sharded over the flattened
               ("data", "model") axes; batch over both axes too
      serve    no FSDP: dense TP over "model", experts EP over "model"
               + d_ff TP over ``cfg.expert_tp_axis``
    """
    tp = mesh_cfg.tp_size if "model" in mesh_cfg.axes else 0
    fa, fs = _fsdp_axis(mesh_cfg), _fsdp_size(mesh_cfg)
    if variant == "flat_dp":
        tp = 0                                    # no Megatron TP anywhere
        fa = tuple(mesh_cfg.axes)                 # flat FSDP
        fs = mesh_cfg.n_devices
    elif variant == "serve":
        fs = 0                                    # disables FSDP fill
    heads_ok = _divisible(cfg.n_heads, tp)
    kv_ok = _divisible(cfg.n_kv_heads, tp)
    ssm_ok = cfg.ssm_head_dim and _divisible(cfg.d_inner // cfg.ssm_head_dim,
                                             tp)

    def mat(d_in_axis, d_out_axis):
        """2D matrix (in, out); axes may be None."""
        spec = [d_in_axis, d_out_axis]
        # FSDP on the first unsharded, divisible dim
        for i in range(2):
            if spec[i] is None and _divisible(shape[i], fs):
                spec[i] = fa
                break
        return P(*spec)

    V = cfg.vocab_size
    vocab_ok = _divisible(V, tp)

    if name == "embed_tokens":                      # (V, D)
        return mat("model" if vocab_ok else None, None)
    if name == "lm_head":                           # (D, V)
        return mat(None, "model" if vocab_ok else None)
    if name in ("wq", "q_a"):                       # (D, H*hd)
        return mat(None, "model" if heads_ok else None)
    if name in ("wk", "wv"):                        # (D, KV*hd)
        return mat(None, "model" if kv_ok else None)
    if name in ("bq",):                             # (H*hd,)
        return P("model") if heads_ok and _divisible(shape[0], tp) \
            else P(None)
    if name in ("bk", "bv"):
        return P("model") if kv_ok and _divisible(shape[0], tp) else P(None)
    if name == "wo":                                # (H*hd, D)
        return mat("model" if heads_ok else None, None)
    if name in ("w_gate", "w_in"):                  # (D, F)
        return mat(None, "model" if _divisible(shape[1], tp) else None)
    if name == "w_out":                             # (F, D)
        return mat("model" if _divisible(shape[0], tp) else None, None)
    if name == "router":                            # (D, E)
        return mat(None, None)
    if name in ("we_gate", "we_in", "we_out"):      # (E, D, Fe) / (E, Fe, D)
        e_ax = "model" if _divisible(shape[0], tp) else None
        if variant == "serve" and cfg.expert_tp_axis:
            # TP within an expert over the data axis: d_ff sharded,
            # outputs partial-summed (moe_forward psums them)
            f_dim = 2 if name in ("we_gate", "we_in") else 1
            spec = [e_ax, None, None]
            spec[f_dim] = cfg.expert_tp_axis
            return P(*spec)
        rest = [None, None]
        for i in (1, 2):
            if _divisible(shape[i], fs):
                rest[i - 1] = fa
                break
        return P(e_ax, *rest)
    if name == "w_kv_a":                            # (D, lora+rope)
        return mat(None, None)
    if name == "w_kv_b":                            # (lora, H*(nope+v))
        return mat(None, "model" if heads_ok else None)
    # --- SSM leaves ---
    if name in ("w_z", "w_x"):                      # (D, d_inner)
        return mat(None, "model" if ssm_ok else None)
    if name in ("w_B", "w_C"):                      # (D, G*N), all heads'
        return mat(None, None)
    if name == "w_dt":                              # (D, n_ssm_heads)
        return mat(None, "model" if ssm_ok else None)
    if name == "conv_x":                            # (K, d_inner)
        return P(None, "model") if ssm_ok else P(None, None)
    if name in ("conv_B", "conv_C"):                # (K, G*N)
        return P(None, None)
    if name in ("A_log", "D_skip", "dt_bias"):      # (n_ssm_heads,)
        return P("model") if ssm_ok else P(None)
    if name == "gate_norm":                         # (d_inner,)
        return P("model") if ssm_ok else P(None)
    # norms / scalars / anything 1-D: replicate
    return P(*([None] * len(shape)))


def _stacked(spec: P) -> P:
    return P(None, *spec)


_STACKS = ("blocks", "enc_blocks")


def param_specs(params: Any, cfg: ModelConfig, mesh_cfg: MeshConfig,
                variant: str = "default"):
    """The spec of every parameter: for the port's ``Model`` a dict of its
    parameter names (``blocks.3.attn.wq``: one layer, no scan dim), for
    the reference's tree (nested dicts of leaves with a ``.shape``, as
    ``jax.eval_shape`` gives them) the same tree, its ``blocks`` /
    ``enc_blocks`` leaves with a leading None."""
    if hasattr(params, "named_parameters"):
        return {n: _leaf_spec(n.rsplit(".", 1)[-1], tuple(t.shape), cfg,
                              mesh_cfg, variant)
                for n, t in params.named_parameters()}

    def visit(tree, keys):
        if isinstance(tree, dict):
            return {k: visit(v, keys + (k,)) for k, v in tree.items()}
        stacked = any(k in _STACKS for k in keys)
        shape = tuple(tree.shape)[1:] if stacked else tuple(tree.shape)
        spec = _leaf_spec(keys[-1], shape, cfg, mesh_cfg, variant)
        return _stacked(spec) if stacked else spec

    return visit(params, ())


def shard_params(params, cfg: ModelConfig, mesh, mesh_cfg: MeshConfig):
    """The parameters on ``mesh``: on one card, as they are (every rank's
    block is a view of them; ``param_specs`` says how the reference
    would place them)."""
    param_specs(params, cfg, mesh_cfg)        # every leaf has a rule
    return params


# --------------------------------------------------------------------------
# activation / cache specs
# --------------------------------------------------------------------------

def activation_spec(mesh_cfg: MeshConfig, batch: int) -> P:
    """(B, S, D) hidden states: batch over dp axes when divisible."""
    dp = _dp_entry(mesh_cfg)
    if batch % mesh_cfg.dp_size == 0:
        return P(dp, None, None)
    if batch % _fsdp_size(mesh_cfg) == 0:
        return P("data", None, None)
    return P(None, None, None)


def tokens_spec(mesh_cfg: MeshConfig, batch: int) -> P:
    a = activation_spec(mesh_cfg, batch)
    return P(a[0], None)


def logits_spec(cfg: ModelConfig, mesh_cfg: MeshConfig, batch: int) -> P:
    a = activation_spec(mesh_cfg, batch)
    vocab_ok = _divisible(cfg.vocab_size, mesh_cfg.tp_size)
    return P(a[0], None, "model" if vocab_ok else None)


def kv_cache_spec(cfg: ModelConfig, mesh_cfg: MeshConfig, batch: int) -> P:
    """KV cache (B, S, KV, hd) [GQA] or (B, S, C) [MLA compressed]:
    sequence-sharded over ``model``, the flash-decode layout that serves
    every kv_heads count."""
    a = activation_spec(mesh_cfg, batch)
    return P(a[0], "model")  # trailing dims replicated


def batch_axis_size(mesh_cfg: MeshConfig, batch: int) -> int:
    """How many ways the batch is actually sharded."""
    if batch % mesh_cfg.dp_size == 0:
        return mesh_cfg.dp_size
    if batch % _fsdp_size(mesh_cfg) == 0:
        return _fsdp_size(mesh_cfg)
    return 1
