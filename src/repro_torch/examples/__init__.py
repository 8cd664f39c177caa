"""The reference's five examples (``examples/*.py``) on the port.

Each runs as ``python -m repro_torch.examples.<name>`` on the card, or on
the CPU with ``--device cpu``, with random params from the port's own
seeded init. Each body is a function of (model, params, device) that
prints what the reference prints and returns it, so a test can feed it
params bridged from the reference:

- ``quickstart``: top-p ``generate``, ``autoquant`` then ``generate``, and
  LayerSkip, lossless against greedy (f32 llama3.2-1b smoke config);
- ``serve_batched``: the launcher on the HumanEval profile;
- ``speech_translation``: S-T beam search on whisper-base's smoke config
  and S-S on seamless-m4t's, batch and served as beam slot groups;
- ``image_generation``: chameleon's T-I contrastive decoding, I-T
  captioning, and the served groups, whose tokens match the batch run;
- ``train_small``: the 67 M-parameter llama trained on the plain path,
  with checkpoints.
"""


def smoke_model(arch: str, device):
    """(model, params from seed 0) of ``arch``'s smoke config in f32 on
    ``device``, as the reference's examples build theirs."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model

    model = get_model(get_smoke_config(arch).replace(dtype="float32"))
    with torch.inference_mode():
        params = model.init(torch.Generator(device=device).manual_seed(0), device)
    return model, params
