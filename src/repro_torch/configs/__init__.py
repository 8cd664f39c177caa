"""Config registry of the port: ``--arch <id>`` resolution. Only the
architectures the port can run are registered."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import (chameleon_34b, deepseek_v2_236b, hstu, llama3_2_1b,
                                 llama3_405b, mamba2_130m, qwen2_5_3b, qwen3_moe_30b_a3b,
                                 recurrentgemma_2b, seamless_m4t, whisper_base, yi_34b)

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "qwen2.5-3b": qwen2_5_3b,
    "yi-34b": yi_34b,
    "llama3-405b": llama3_405b,
    "mamba2-130m": mamba2_130m,
    "recurrentgemma-2b": recurrentgemma_2b,
    "hstu": hstu,
    "whisper-base": whisper_base,
    "seamless-m4t": seamless_m4t,
    "chameleon-34b": chameleon_34b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b,
    "deepseek-v2-236b": deepseek_v2_236b,
}

CONFIGS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE_CONFIGS: Dict[str, ModelConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_config(arch: str) -> ModelConfig:
    if arch not in CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(CONFIGS)}")
    return CONFIGS[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in SMOKE_CONFIGS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(SMOKE_CONFIGS)}")
    return SMOKE_CONFIGS[arch]
