"""Per-layer metric readers: ``metrics/<metric name>.py`` defines
``read(record) -> float | None``. A reader that finds nothing returns None and
the harness leaves the metric out of the line."""
