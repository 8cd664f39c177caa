"""Serving core of the port: KV slot-pool, engine, scheduler, and
AutoQuant (``quantization``)."""
from repro_torch.core import quantization  # noqa: F401
