"""Synthetic data of the port (`synthetic`: images, token streams, client shares)."""
