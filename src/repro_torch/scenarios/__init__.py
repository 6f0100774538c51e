"""Scenario registry: named, seedable channel/population families.

Importing this package registers the four families of the reference
(``iid_rayleigh``, the paper's Table-I deployment; ``ris_geometry``;
``gauss_markov``; ``hetero_classes``). See `base.py`.
"""
from .base import (
    DEFAULT_STREAM_BBAR,
    DEFAULT_STREAM_SIZES,
    ScenarioFamily,
    generator,
    get_family,
    list_families,
    register,
    table1_population,
)
from . import iid_rayleigh as _iid_rayleigh  # noqa: F401  (registers)
from . import ris_geometry as _ris_geometry  # noqa: F401
from . import gauss_markov as _gauss_markov  # noqa: F401
from . import hetero_classes as _hetero_classes  # noqa: F401
from .hetero_classes import DeviceClass, build_classes

__all__ = [
    "DEFAULT_STREAM_BBAR",
    "DEFAULT_STREAM_SIZES",
    "DeviceClass",
    "ScenarioFamily",
    "build_classes",
    "generator",
    "get_family",
    "list_families",
    "register",
    "table1_population",
]
