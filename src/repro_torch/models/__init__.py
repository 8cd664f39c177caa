"""Model families of the port: ``dense`` (transformer), ``vlm``, ``encdec``,
``seamless``, ``hstu`` and ``ssm``."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
