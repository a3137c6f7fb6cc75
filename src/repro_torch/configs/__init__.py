"""Architecture config registry: ``get(name)`` / ``--arch <id>``.

Each module defines ``CONFIG`` (the exact assigned architecture) built on
:class:`repro_torch.models.config.ModelConfig`; ``CONFIG.reduced()`` is the
CPU-smoke variant.  Input shapes live in :mod:`repro_torch.configs.shapes`.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "qwen3_14b",
    "qwen3_moe_235b_a22b",
    "qwen2_vl_72b",
    "xlstm_125m",
    "h2o_danube_3_4b",
    "stablelm_12b",
    "mixtral_8x22b",
    "jamba_1_5_large_398b",
    "whisper_small",
    "codeqwen1_5_7b",
)

_ALIASES = {
    "qwen3-14b": "qwen3_14b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-125m": "xlstm_125m",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "stablelm-12b": "stablelm_12b",
    "mixtral-8x22b": "mixtral_8x22b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-small": "whisper_small",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCH_IDS}
