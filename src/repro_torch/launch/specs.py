"""Frontend geometry, per-arch training config and run assembly
(counterpart of the start and end of ``repro/launch/specs.py``).

``vlm_prefix_len``, ``frontend_geometry``, ``train_config_for`` and
``make_run`` are ported. The reference's input specs and sharding
functions map abstract trees onto a production mesh for XLA; the port
runs on one device, and those functions are not ported (ROADMAP Queue 1
item 12, the distributed entry).
"""
from __future__ import annotations

from repro_torch.config import (MeshConfig, ModelConfig, RunConfig,
                                ShapeConfig, TrainConfig)


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
