"""Checkpoints of trees of tensors (`checkpoint.io`)."""
