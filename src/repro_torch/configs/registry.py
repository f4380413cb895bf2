"""Arch registry of the port (counterpart of ``repro/configs/registry.py``).

It lists only the archs whose every layer the port runs: the dense
families, the attention-free ``ssm`` family, deepseek-v2-lite's MoE
stack (MLA attention, one leading dense layer) and jamba's hybrid stack
(SSD and GQA attention layers, MoE on every other layer). Any other arch
of the reference raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

_MODULES = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_52b",
}

ARCH_IDS: list[str] = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP Queue 1 item 12); "
            f"the port runs {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
