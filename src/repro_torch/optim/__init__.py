"""Optimizers of the port (`optimizers.sgd`, `optimizers.adamw`)."""
