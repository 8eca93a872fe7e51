"""Utilities: the weight bridge from the JAX package's parameter trees."""
