"""Transformer building blocks of the port (tensor-parallel size 1)."""
