"""Meshes: the sharding rules (`sharding`) and the collectives of the model's mesh path (`collectives`)."""
