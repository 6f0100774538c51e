"""Scenario registry: named, seedable channel/population families.

Importing this package registers the ported families (so far
``iid_rayleigh``, the paper's Table-I deployment). See `base.py`.
"""
from .base import (
    ScenarioFamily,
    generator,
    get_family,
    list_families,
    register,
    table1_population,
)
from . import iid_rayleigh as _iid_rayleigh  # noqa: F401  (registers)

__all__ = [
    "ScenarioFamily",
    "generator",
    "get_family",
    "list_families",
    "register",
    "table1_population",
]
