"""Model registry: resolves a ModelConfig to its family module and wraps it
in a uniform ``Model`` handle used by the engine, launcher and tests (the
counterpart of ``repro/models/registry.py``; the dense, VLM, MoE, MLA + MoE,
encoder-decoder, Seamless, HSTU, SSM and hybrid families).

A tensor-parallel rank's ``Model`` carries its group (``tp``, see
``distributed/tp_pool.py``): its config has the rank's widths, and its
forward reduces over the group (the dense, vlm, moe, mla_moe, ssm, encdec,
seamless and hybrid families); a hybrid rank's caches also take the group,
which decides whether its rings split along their rows. A ``Model`` bound
to an expert-parallel group (``ep``, ``distributed/tp_pool.ep_group``; the
``moe`` and ``mla_moe`` families) runs every MoE layer through
``moe.moe_ffn_ep`` on its params' block of experts
(``sharding.ep_param_specs``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hstu, hybrid, seamless, ssm, transformer, vlm

#: the families whose MoE layers run under expert parallelism
EP_FAMILIES = ("moe", "mla_moe")

_FAMILIES = {"dense": transformer, "moe": transformer, "mla_moe": transformer, "vlm": vlm,
             "encdec": encdec, "seamless": seamless, "hstu": hstu, "ssm": ssm,
             "hybrid": hybrid}


@dataclass(frozen=True)
class Model:
    config: ModelConfig
    module: Any
    tp: Any = None  # a rank's TPGroup; None on one device
    ep: Any = None  # a rank's expert-parallel group (tp_pool.ep_group)

    def init(self, gen: torch.Generator, device) -> Any:
        return self.module.init(self.config, gen, device)

    def init_cache(self, batch: int, max_len: int, device) -> Any:
        kw = {} if self.tp is None or self.config.hybrid is None else {"tp": self.tp}
        return self.module.init_cache(self.config, batch, max_len, device, **kw)

    def forward(
        self,
        params,
        batch: Dict[str, torch.Tensor],
        *,
        cache=None,
        mode: str = "train",
        impl: str = "auto",
    ) -> Tuple[torch.Tensor, Optional[Any], Dict[str, torch.Tensor]]:
        kw = {} if self.tp is None else {"tp": self.tp}
        if self.ep is not None:
            if self.config.family not in EP_FAMILIES:
                raise NotImplementedError(
                    f"expert parallelism runs the {', '.join(EP_FAMILIES)} families, not "
                    f"{self.config.family!r}")
            kw["ep"] = self.ep
        return self.module.forward(self.config, params, batch, cache=cache, mode=mode,
                                   impl=impl, **kw)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves {sorted(_FAMILIES)}"
        )
    return Model(config=cfg, module=_FAMILIES[cfg.family])
