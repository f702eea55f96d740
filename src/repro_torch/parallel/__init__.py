"""Logical sharding rules, placement and gradient compression (port of the
JAX package's `parallel`): the rules resolve specs for any mesh shape;
tensors are placed by them as DTensors on a mesh over a process group."""
