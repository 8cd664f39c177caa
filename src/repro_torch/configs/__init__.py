"""Config registry of the port: ``--arch <id>`` resolution. Only the
architectures the port can run are registered."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs import llama3_2_1b

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
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
