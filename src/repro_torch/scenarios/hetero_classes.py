"""Heterogeneous device-class population family.

Counterpart of `repro.scenarios.hetero_classes`, the same law drawn with a
`torch.Generator`. Device classes come from the architecture registry
(`repro_torch.configs.registry`): each arch's analytic
``active_param_count()`` sets its class's relative per-sample compute, and
each device draws its class uniformly, taking that class's ``c``
(cycles/sample, with +/-10% within-class jitter), ``f_max`` (CPU tier) and
``p_max`` (radio tier).

Cycle counts are normalised so the smallest class lands at the paper's
Table-I floor (1e4 cycles/sample) and scale with the cube root of the
active-parameter ratio. The channel itself is the Section-V i.i.d.
Rayleigh law, so any objective difference against `iid_rayleigh` comes
from the population alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..configs.registry import get_config, list_archs
from ..core.types import SystemParams, dbm_to_watt
from .base import (
    ScenarioFamily, large_scale_db, rayleigh_power, register, table1_population, uniform,
)


class DeviceClass(NamedTuple):
    """One device tier: representative arch + allocator-visible resources."""

    arch: str
    c_cycles: float      # cycles per sample (class centre, +/-10% jitter)
    f_max_hz: float      # CPU frequency ceiling
    p_max_dbm: float     # transmit power ceiling

    @property
    def p_max_w(self) -> float:
        """The power ceiling in W, rounded through float32."""
        return float(dbm_to_watt(self.p_max_dbm))


#: Table-I floor for the smallest class's cycles/sample
_C_FLOOR = 1e4
#: CPU and radio tiers, smallest model class first
_F_TIERS = (1.0e9, 2.0e9, 4.0e9)
_P_TIERS = (17.0, 20.0, 23.0)


def build_classes(n_classes: int = 3) -> tuple[DeviceClass, ...]:
    """Partition the registry's archs into ``n_classes`` size tiers.

    Archs are sorted by ``active_param_count()`` and split into contiguous
    groups; each group's median arch represents the class. ``c`` scales with
    the cube root of the active-parameter ratio to the smallest class,
    anchored at the Table-I floor.
    """
    if not 1 <= n_classes <= len(_F_TIERS):
        raise ValueError(f"n_classes must be in [1, {len(_F_TIERS)}], got {n_classes}")
    sized = sorted(
        ((get_config(a).active_param_count(), a) for a in list_archs()),
    )
    groups = [sized[(i * len(sized)) // n_classes : ((i + 1) * len(sized)) // n_classes]
              for i in range(n_classes)]
    reps = [g[len(g) // 2] for g in groups]
    base = reps[0][0]
    return tuple(
        DeviceClass(
            arch=arch,
            c_cycles=_C_FLOOR * float((count / base) ** (1.0 / 3.0)),
            f_max_hz=_F_TIERS[i],
            p_max_dbm=_P_TIERS[i],
        )
        for i, (count, arch) in enumerate(reps)
    )


class HeteroClasses(ScenarioFamily):
    name = "hetero_classes"

    def __init__(self, classes: tuple[DeviceClass, ...] | None = None):
        self._classes = classes

    @property
    def classes(self) -> tuple[DeviceClass, ...]:
        if self._classes is None:
            self._classes = build_classes()
        return self._classes

    def draw(
        self,
        gen: torch.Generator,
        lead: tuple,
        *,
        device,
        N: int = 10,
        K: int = 50,
        B: float = 20e6,
        radius_m: float = 500.0,
        shadowing_db: float = 8.0,
        eta: int = 10,
        q: int = 2,
        **population,
    ) -> SystemParams:
        dev_shape = tuple(lead) + (N,)
        # Section-V channel, as in iid_rayleigh
        pl_shadow_db = large_scale_db(gen, dev_shape, radius_m, shadowing_db, device)
        ray = rayleigh_power(gen, dev_shape + (K,), device)
        gain_lin = 10.0 ** (-pl_shadow_db[..., None] / 10.0) * ray

        # per-device class draw + gather of the class resource columns
        classes = self.classes
        tab = lambda vals: torch.tensor(vals, dtype=torch.float32, device=device)
        c_tab = tab([cl.c_cycles for cl in classes])
        f_tab = tab([cl.f_max_hz for cl in classes])
        p_tab = tab([cl.p_max_w for cl in classes])
        idx = torch.randint(0, len(classes), dev_shape, generator=gen, device=device)
        jitter = uniform(gen, dev_shape, 0.9, 1.1, device)

        pop = table1_population(N, lead=lead, device=device, **population)
        pop["p_max"] = p_tab[idx]
        pop["f_max"] = f_tab[idx]
        return SystemParams(
            g=gain_lin,
            c=c_tab[idx] * jitter,
            **pop,
            N=N,
            K=K,
            B=B,
            q=q,
            eta=eta,
        )


FAMILY = register(HeteroClasses())
