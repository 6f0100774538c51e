"""Model configurations of the port (`registry.get_config`)."""
