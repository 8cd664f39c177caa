"""Model registry: resolves a ModelConfig to its family module and wraps it
in a uniform ``Model`` handle used by the engine, launcher and tests (the
counterpart of ``repro/models/registry.py``; dense family only)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES = {"dense": transformer}


@dataclass(frozen=True)
class Model:
    config: ModelConfig
    module: Any

    def init(self, gen: torch.Generator, device) -> Any:
        return self.module.init(self.config, gen, device)

    def init_cache(self, batch: int, max_len: int, device) -> Any:
        return self.module.init_cache(self.config, batch, max_len, device)

    def forward(
        self,
        params,
        batch: Dict[str, torch.Tensor],
        *,
        cache=None,
        mode: str = "train",
        impl: str = "auto",
    ) -> Tuple[torch.Tensor, Optional[Any], Dict[str, torch.Tensor]]:
        return self.module.forward(self.config, params, batch, cache=cache, mode=mode,
                                   impl=impl)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves {sorted(_FAMILIES)}"
        )
    return Model(config=cfg, module=_FAMILIES[cfg.family])
