"""Serving: bit-plane quantization of parameters, the serving engine and
the continuous batcher."""
from .scheduler import ContinuousBatcher, Request  # noqa: F401
