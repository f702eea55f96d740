"""Synthetic language-model data (port of the JAX package's `data`)."""
