"""Utilities: the JAX weight bridge and seeded random weights."""
