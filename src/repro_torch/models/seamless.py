"""SeamlessM4T-style 4-module speech-translation model (paper §2.1.3) — the
counterpart of ``repro/models/seamless.py``.

Only one of the four modules is autoregressive (Fig 2c, Fig 7):

  1. speech encoder — the encdec bidirectional encoder over stubbed frame
     embeddings;
  2. T2TT text decoder — autoregressive, beam search, KV reorder (the encdec
     decoder; the paper's Obs #2/#4 subject);
  3. NAR T2U — text to units in one forward (x ``UPSAMPLE_T2U`` length);
  4. vocoder — HiFi-GAN analogue: unit embeddings, then upsampling,
     depthwise conv, leaky ReLU and a channel projection per block: a long
     chain of cheap kernels.

S-T / T-T use modules 1-2; S-S / T-S also run 3-4.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import ssm

N_UNITS = 10_000  # discrete speech units (paper: XLS-R k-means units)
UPSAMPLE_T2U = 2  # text tokens -> units
UPSAMPLE_VOCODER = (4, 4)  # unit -> waveform sample rate factors
VOC_CHANNELS = (256, 128, 64)
VOC_KERNEL = 7
#: each vocoder block's upsampling: the reference's ``UPSAMPLE_VOCODER + (1,)``
#: cut to one factor per channel stage
VOC_BLOCK_FACTORS = (UPSAMPLE_VOCODER + (1,) * len(VOC_CHANNELS))[: len(VOC_CHANNELS)]

# the T2TT backbone is the encdec model
init_cache = encdec.init_cache


def init(cfg: ModelConfig, gen: torch.Generator, device):
    p = encdec.init(cfg, gen, device)
    p["t2u"] = init_t2u(cfg, gen, device)
    p["vocoder"] = init_vocoder(cfg, gen, device)
    return p


def forward(cfg: ModelConfig, params, batch, *, cache=None, mode="train", impl="auto",
            tp=None):
    """The model API is the autoregressive T2TT path (modules 1-2); the NAR
    T2U and the vocoder run via :func:`t2u_forward` / :func:`vocode`. ``tp``
    serves the backbone as a tensor-parallel rank (``encdec.forward``); T2U
    and the vocoder have no TP path, as in the reference."""
    backbone = {k: v for k, v in params.items() if k not in ("t2u", "vocoder")}
    return encdec.forward(cfg, backbone, batch, cache=cache, mode=mode, impl=impl, tp=tp)


# --------------------------------------------------------------------------
# module 3: NAR text-to-unit
# --------------------------------------------------------------------------

def init_t2u(cfg: ModelConfig, gen: torch.Generator, device):
    dt = L.param_dtype(cfg)
    d = cfg.d_model
    return {
        "embed": L.embedding_init(gen, cfg.vocab_size, d, dt, device),
        "layers": [encdec.init_encoder_layer(gen, cfg, device) for _ in range(2)],
        "norm": L.rmsnorm_init(d, dt, device),
        "unit_head": L.dense_init(gen, d, N_UNITS, dt, device),
    }


def t2u_forward(cfg: ModelConfig, p, text_tokens: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """NAR T2U: text tokens [B, T] -> unit logits [B, T * UPSAMPLE_T2U,
    N_UNITS] f32 in ONE forward (no decode loop)."""
    x = L.embed(p["embed"], text_tokens).repeat_interleave(UPSAMPLE_T2U, dim=1)
    tu, d = x.shape[1], x.shape[2]
    x = x + L.sinusoid_positions(tu, d, x.device).to(x.dtype)[None]
    h = encdec.bidirectional_stack(cfg, p["layers"], x, p["norm"], impl)
    return L.dense(p["unit_head"], h, impl).float()


# --------------------------------------------------------------------------
# module 4: vocoder (HiFi-GAN analogue)
# --------------------------------------------------------------------------

def init_vocoder(cfg: ModelConfig, gen: torch.Generator, device):
    dt = L.param_dtype(cfg)
    p = {"unit_embed": L.embedding_init(gen, N_UNITS, VOC_CHANNELS[0], dt, device)}
    chans = VOC_CHANNELS + (1,)
    for i, c in enumerate(VOC_CHANNELS):
        w = torch.randn((c, VOC_KERNEL), generator=gen, device=device, dtype=torch.float32)
        p[f"conv{i}_w"] = (w * (VOC_KERNEL * c) ** -0.5).to(dt)
        p[f"conv{i}_b"] = torch.zeros((c,), dtype=dt, device=device)
        p[f"proj{i}"] = L.dense_init(gen, c, chans[i + 1], dt, device)
    return p


def vocode(cfg: ModelConfig, p, units: torch.Tensor) -> torch.Tensor:
    """units [B, U] -> waveform [B, U * prod(UPSAMPLE_VOCODER)]: per block a
    nearest-neighbour upsample, a width-7 depthwise causal conv, leaky ReLU
    (0.1) and a channel projection — plain torch (the reference has no
    Pallas kernel here)."""
    x = L.embed(p["unit_embed"], units)  # [B, U, C0]
    for i, factor in enumerate(VOC_BLOCK_FACTORS):
        if factor > 1:
            x = x.repeat_interleave(factor, dim=1)
        y, _ = ssm._causal_conv(x, p[f"conv{i}_w"], p[f"conv{i}_b"], None)
        x = L.dense(p[f"proj{i}"], F.leaky_relu(y, 0.1))
    return x[..., 0]  # [B, samples]


# --------------------------------------------------------------------------
# task pipelines (paper Table 1)
# --------------------------------------------------------------------------

def speech_to_speech(
    model, params, *, frames: torch.Tensor, bos_id: int = 1, eos_id: int = 2,
    n_beams: int = 4, max_text_len: int = 32, impl: str = "auto",
) -> Dict[str, torch.Tensor]:
    """S-S: beam-decode the translated text (autoregressive, modules 1-2),
    then one NAR T2U forward and one vocoder forward (modules 3-4)."""
    from repro_torch.core import engine

    cfg = model.config
    text = engine.generate_beam(
        model, params, batch=frames.shape[0], n_beams=n_beams, bos_id=bos_id,
        eos_id=eos_id, max_new_tokens=max_text_len, extra_inputs={"frames": frames},
        impl=impl,
    )
    with torch.inference_mode():
        unit_logits = t2u_forward(cfg, params["t2u"], text["tokens"], impl)
        units = torch.argmax(unit_logits, dim=-1).to(torch.int32)
        wave = vocode(cfg, params["vocoder"], units)
    return {"text": text["tokens"], "units": units, "waveform": wave,
            "n_decode_steps": text["n_steps"]}
