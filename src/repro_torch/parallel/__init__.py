"""Logical sharding rules and gradient compression (port of the JAX
package's `parallel`): the rules resolve specs for any mesh shape; tensors
are placed on one device only."""
