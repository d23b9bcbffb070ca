"""Architecture config registry (port of ``src/repro/configs``; data only).
``get_config(name)`` returns the exact published configuration;
``get_config(name).reduced()`` is the CPU smoke variant. ``ARCH_IDS``
lists the 10 assigned architectures; ``blendfl_paper`` is the paper's
own xLSTM-pair backbone."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "phi4_mini_3p8b",
    "starcoder2_7b",
    "nemotron_4_15b",
    "whisper_medium",
    "deepseek_moe_16b",
    "stablelm_3b",
    "qwen2_vl_2b",
    "hymba_1p5b",
    "xlstm_350m",
    "dbrx_132b",
]

# CLI-friendly aliases (the assignment's dashed ids)
ALIASES = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "starcoder2-7b": "starcoder2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "whisper-medium": "whisper_medium",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "stablelm-3b": "stablelm_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "hymba-1.5b": "hymba_1p5b",
    "xlstm-350m": "xlstm_350m",
    "dbrx-132b": "dbrx_132b",
    "blendfl-paper": "blendfl_paper",
}


def get_config(name: str) -> ArchConfig:
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
