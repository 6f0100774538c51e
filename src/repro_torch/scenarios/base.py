"""`ScenarioFamily` base class + the string-keyed scenario registry.

Counterpart of `repro.scenarios.base`. A family is named (its registry key)
and seedable: every draw comes from a `torch.Generator` (or an int seed that
makes one) on the requested device. A family draws the same distribution as
its reference counterpart, not the same numbers: JAX's threefry streams
cannot be reproduced in torch.

    from repro_torch.scenarios import get_family
    fam = get_family("iid_rayleigh")
    params = fam.sample(0, N=10, K=50)                 # one SystemParams, on cuda
    batch = fam.sample_batch(0, 16, N=10, K=50)        # stacked (16, N, K)

``sample_batch`` draws one leading batch shape from one generator: its rows
are i.i.d. draws of the family's law, but not the draws ``sample`` would make
one by one (the reference's "batch == stacked singles" holds there by
`vmap` over split keys). ``stream``, the serving layer's request stream,
comes with the serving slice and raises until then.
"""
from __future__ import annotations

import torch

from ..core.types import SystemParams, dbm_to_watt
from ..device import resolve_device

#: default mixed-size serving stream (the reference's ``(N, K)`` sizes)
DEFAULT_STREAM_SIZES = ((3, 8), (4, 12), (6, 16))
#: default per-subcarrier bandwidth of a stream: the Table-I B/K
DEFAULT_STREAM_BBAR = 20e6 / 50


def table1_population(
    N: int,
    *,
    lead: tuple = (),
    device=None,
    d_samples: float = 500.0,
    D_bits: float = 2.81e4,
    C_round_bits: float = 4.15e6,
    L_rounds: int = 10,
    t_sc_max: float = 20.0,
    p_max_dbm: float = 20.0,
    f_max_hz: float = 2e9,
) -> dict:
    """The paper's Table-I homogeneous device population as `SystemParams`
    keyword tensors of shape ``lead + (N,)`` (everything but the channel
    gain ``g`` and cycles ``c``)."""
    ones = torch.ones(tuple(lead) + (N,), dtype=torch.float32, device=device)
    return dict(
        d=d_samples * ones,
        D=D_bits * ones,
        C=(C_round_bits * L_rounds) * ones,
        p_max=dbm_to_watt(p_max_dbm, device=device) * ones,
        f_max=f_max_hz * ones,
        t_sc_max=t_sc_max * ones,
    )


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """float32 draws uniform in [lo, hi)."""
    u = torch.rand(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return lo + (hi - lo) * u


def large_scale_db(gen: torch.Generator, shape, radius_m: float, shadowing_db: float,
                   device) -> torch.Tensor:
    """The Section-V path loss plus shadowing in dB, of devices uniform in a
    disc: 128.1 + 37.6 log10(dist_km) with ``shadowing_db`` log-normal
    shadowing (the reference's ``iid_rayleigh``, ``gauss_markov`` and
    ``hetero_classes`` law)."""
    # uniform in a disc => r ~ sqrt(U) * radius
    u = uniform(gen, shape, 1e-3, 1.0, device)
    dist_km = torch.sqrt(u) * radius_m / 1000.0
    pl_db = 128.1 + 37.6 * torch.log10(dist_km)
    return pl_db + shadowing_db * torch.randn(
        tuple(shape), generator=gen, device=device, dtype=torch.float32
    )


def rayleigh_power(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Unit-mean exponential (Rayleigh power) fading, float32."""
    ray = torch.empty(tuple(shape), device=device, dtype=torch.float32)
    return ray.exponential_(generator=gen)


def generator(seed, device) -> torch.Generator:
    """A `torch.Generator` on ``device``: ``seed`` is an int or a generator
    (which must live on that device)."""
    if isinstance(seed, torch.Generator):
        if seed.device.type != torch.device(device).type:
            raise ValueError(f"generator is on {seed.device}, draws requested on {device}")
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


class ScenarioFamily:
    """Base class for registered scenario generators (module docstring).

    Subclasses set ``name`` and implement ``draw``, which returns scenarios
    with any leading batch shape; ``sample`` and ``sample_batch`` call it.
    """

    #: registry key; subclasses must override
    name: str = ""

    def draw(self, gen: torch.Generator, lead: tuple, *, device, **kwargs) -> SystemParams:
        raise NotImplementedError

    def sample(self, seed, *, device="cuda", **kwargs) -> SystemParams:
        """Draw one exact-shape scenario."""
        dev = resolve_device(device)
        return self.draw(generator(seed, dev), (), device=dev, **kwargs)

    def sample_batch(self, seed, batch: int, *, device="cuda", **kwargs) -> SystemParams:
        """Draw ``batch`` i.i.d. scenarios stacked on a leading axis."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        dev = resolve_device(device)
        return self.draw(generator(seed, dev), (batch,), device=dev, **kwargs)

    def stream(self, seed, n_requests: int, **kwargs):
        """The serving layer's mixed-size request stream: not ported yet."""
        raise NotImplementedError(
            f"{self.name}.stream (the serving request stream) is not ported yet: "
            "ROADMAP.md §1, item 8 (serving)"
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FAMILIES: dict[str, ScenarioFamily] = {}


def register(family: ScenarioFamily) -> ScenarioFamily:
    """Register a family instance under ``family.name`` (unique)."""
    if not family.name:
        raise ValueError(f"{type(family).__name__} has no name; set .name")
    if family.name in _FAMILIES:
        raise ValueError(f"scenario family {family.name!r} already registered")
    _FAMILIES[family.name] = family
    return family


def get_family(name: str) -> ScenarioFamily:
    """Resolve a registered family by name."""
    try:
        return _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario family {name!r}; registered: {list_families()}"
        ) from None


def list_families() -> tuple[str, ...]:
    return tuple(sorted(_FAMILIES))
