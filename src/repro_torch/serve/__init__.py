"""Serving: bit-plane quantization of parameters and the serving engine."""
