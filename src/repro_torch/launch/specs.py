"""Frontend geometry, input specs, sharding assembly, per-arch training
config and run assembly (counterpart of ``repro/launch/specs.py``).

``input_specs`` and ``decode_input_specs`` return ``meta`` tensors of the
reference's shapes and dtypes, the port's ``ShapeDtypeStruct``: the dry
run (``launch/dryrun.py``) runs its programs on them, without data.

The sharding builders map each tree onto a mesh by the rules of
``distributed/sharding.py``. On one card a sharding is a spec on a
virtual mesh (``distributed.mesh.NamedSharding``), not a placement:
``dp_entry_for`` is what the model stack's ``dp_entry`` takes, and the
cache specs are the layouts ``collectives.shard_map`` blocks by.
"""
from __future__ import annotations

import torch

from repro_torch.config import (MeshConfig, ModelConfig, RunConfig,
                                ShapeConfig, TrainConfig)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import NamedSharding
from repro_torch.distributed.sharding import P
from repro_torch.models.layers import dtype_of

META = torch.device("meta")


def vlm_prefix_len(seq_len: int) -> int:
    return min(1024, seq_len // 4)


def frontend_geometry(cfg: ModelConfig, shape: ShapeConfig
                      ) -> tuple[int, int, int]:
    """(text_len, frontend_len, enc_len). seq_len budgets the full context
    (image prefix + text for VLM; decoder length for audio)."""
    S = shape.seq_len
    if cfg.frontend == "vision_stub":
        f = vlm_prefix_len(S)
        return S - f, f, 0
    if cfg.n_enc_layers:
        enc = S // max(cfg.enc_seq_factor, 1)
        return S, enc, enc
    return S, 0, 0


# ---------------------------------------------------------------------------
# input specs (meta tensors)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Batch stand-ins for train and prefill (decode takes
    ``decode_input_specs``): int32 ``tokens`` (and ``labels`` to train)
    of (B, S_text), and a frontend's ``frontend_embeds`` (B, S_f, D) in
    the model dtype."""
    B = shape.global_batch
    S_text, S_f, _ = frontend_geometry(cfg, shape)
    batch = {"tokens": torch.empty((B, S_text), dtype=torch.int32,
                                   device=META)}
    if shape.is_train:
        batch["labels"] = torch.empty((B, S_text), dtype=torch.int32,
                                      device=META)
    if S_f:
        batch["frontend_embeds"] = torch.empty((B, S_f, cfg.d_model),
                                               dtype=dtype_of(cfg),
                                               device=META)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """(cache, tokens_t, t) stand-ins for one serve step at context
    ``seq_len``: the zero caches of ``transformer.init_cache``, (B, 1)
    int32 tokens and a 0-d int32 position."""
    from repro_torch.models import transformer as tf
    B = shape.global_batch
    _, _, enc_len = frontend_geometry(cfg, shape)
    cache = tf.init_cache(cfg, B, shape.seq_len, enc_len=enc_len,
                          device=META)
    tokens_t = torch.empty((B, 1), dtype=torch.int32, device=META)
    t = torch.empty((), dtype=torch.int32, device=META)
    return cache, tokens_t, t


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def dp_entry_for(shape: ShapeConfig, mesh_cfg: MeshConfig,
                 variant: str = "default"):
    B = shape.global_batch
    if variant == "flat_dp" and B % mesh_cfg.n_devices == 0:
        return tuple(mesh_cfg.axes)        # batch over the whole mesh
    if B % mesh_cfg.dp_size == 0:
        axes = mesh_cfg.dp_axes
        return axes[0] if len(axes) == 1 else tuple(axes)
    for ax, sz in zip(mesh_cfg.axes, mesh_cfg.shape):
        if ax == "data" and B % sz == 0:
            return "data"
    return None


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    mesh_cfg: MeshConfig, batch_struct: dict,
                    variant: str = "default") -> dict:
    """Each batch leaf (anything with a ``.shape``) split over the dp
    entry on its leading dim."""
    dp = dp_entry_for(shape, mesh_cfg, variant)
    return {k: NamedSharding(mesh, P(dp, *([None] * (len(v.shape) - 1))))
            for k, v in batch_struct.items()}


def params_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig, params,
                     variant: str = "default"):
    """``param_specs``' tree (a ``Model``'s names, or the reference's
    tree) with each spec on ``mesh``."""
    def on(tree):
        if isinstance(tree, dict):
            return {k: on(v) for k, v in tree.items()}
        return NamedSharding(mesh, tree)
    return on(shd.param_specs(params, cfg, mesh_cfg, variant))


def state_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig, state,
                    variant: str = "default"):
    """``TrainState(params, AdamWState(step, mu, nu), residual)`` of
    shardings: the moments and residuals (lists in the parameters'
    order) take their parameter's, the step counter is replicated."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.train_step import TrainState
    p_sh = params_shardings(cfg, mesh, mesh_cfg, state.params, variant)
    leaves = list(p_sh.values())
    return TrainState(
        params=p_sh,
        opt=AdamWState(step=NamedSharding(mesh, P()), mu=leaves,
                       nu=leaves),
        residual=None if state.residual is None else leaves)


def _cache_leaf_spec(name: str, shape: tuple[int, ...], cfg: ModelConfig,
                     mesh_cfg: MeshConfig, dp) -> P:
    tp = mesh_cfg.tp_size
    if name in ("k", "v", "cross_k", "cross_v"):     # (B, S, KV, hd)
        seq_ok = shape[1] % tp == 0
        return P(dp, "model" if seq_ok else None, None, None)
    if name == "ckv":                                 # (B, S, lora+rope)
        seq_ok = shape[1] % tp == 0
        return P(dp, "model" if seq_ok else None, None)
    if name == "state":                               # (B, H, P, N)
        return P(dp, "model" if shape[1] % tp == 0 else None, None, None)
    if name.startswith("conv_"):                      # (B, K-1, C)
        return P(dp, None, "model" if shape[2] % tp == 0 else None)
    return P(dp, *([None] * (len(shape) - 1)))


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    mesh_cfg: MeshConfig, cache_struct):
    """The decode caches' shardings: the port's ``{"blocks": [layer's
    dict, ...]}`` (one layer a dict) or the reference's tree (its
    ``blocks`` leaves stacked, with a leading None)."""
    dp = dp_entry_for(shape, mesh_cfg)

    def visit(tree, keys):
        if isinstance(tree, dict):
            return {k: visit(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [visit(v, keys + (i,)) for i, v in enumerate(tree)]
        stacked = "blocks" in keys and not any(isinstance(k, int)
                                               for k in keys)
        shp = tuple(tree.shape)[1:] if stacked else tuple(tree.shape)
        spec = _cache_leaf_spec(keys[-1], shp, cfg, mesh_cfg, dp)
        return NamedSharding(mesh, P(None, *spec) if stacked else spec)

    return visit(cache_struct, ())


# ---------------------------------------------------------------------------
# per-arch training config (memory-driven numerics)
# ---------------------------------------------------------------------------

def train_config_for(cfg: ModelConfig) -> TrainConfig:
    """Memory-driven numerics: bf16 moments and accumulation above 100 B
    parameters, fp32 below; full remat."""
    big = cfg.param_count() > 100e9
    return TrainConfig(
        moment_dtype="bfloat16" if big else "float32",
        accum_dtype="bfloat16" if big else "float32",
        remat_policy="full",
    )


def make_run(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
             **kw) -> RunConfig:
    return RunConfig(model=cfg, shape=shape, mesh=mesh_cfg,
                     train=train_config_for(cfg), **kw)
