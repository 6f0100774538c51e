"""Synthetic data of the port (`synthetic.image_batch`)."""
