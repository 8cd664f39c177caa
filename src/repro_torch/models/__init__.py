"""Dense decoder-only model of the port (family ``dense``)."""
from repro_torch.models.registry import Model, get_model  # noqa: F401
