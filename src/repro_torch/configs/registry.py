"""Arch registry and cell matrix of the port (counterpart of
``repro/configs/registry.py``).

It lists the reference's ten archs in the reference's order: the dense
families (codeqwen's qkv bias, stablelm's LayerNorm with per-head
qk-norm at head dim 160), the attention-free ``ssm`` family, the MoE
stacks (deepseek-v2-lite's MLA attention and one leading dense layer;
llama4-maverick's dense and MoE layers 1:1 with 128 experts top-1 and a
shared expert), jamba's hybrid stack (SSD and GQA attention layers, MoE
on every other layer), whisper-tiny's encoder and cross-attention and
internvl2-26b's vision prefix.

``runnable_cells()`` enumerates every (arch x shape) pair under the
reference's skip rule: ``long_500k`` needs sub-quadratic
attention, so it runs only for the SSM, hybrid and SWA archs and is
recorded as a skip for the pure full-attention ones.
"""
from __future__ import annotations

import importlib

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}

ARCH_IDS: list[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).SMOKE


def shape_cells() -> dict[str, ShapeConfig]:
    return dict(SHAPES)


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip recorded "
                       "in DESIGN.md)")
    return True, ""


def runnable_cells(include_skips: bool = False):
    """[(arch_id, shape_name, runnable, reason)] over every arch."""
    out = []
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for sname, shape in SHAPES.items():
            ok, why = cell_status(cfg, shape)
            if ok or include_skips:
                out.append((arch_id, sname, ok, why))
    return out
