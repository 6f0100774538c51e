"""Gauss-Markov (AR(1)) time-correlated fading family.

Counterpart of `repro.scenarios.gauss_markov`, the same law drawn with a
`torch.Generator`. Each subcarrier's small-scale fading is the complex
envelope ``h = (x + iy) / sqrt(2)`` of two standard normals, so the power
gain ``|h|^2 = (x^2 + y^2) / 2`` has the exponential (Rayleigh-power)
marginal of `iid_rayleigh`; path loss, shadowing and the population are
`iid_rayleigh`'s. ``sample``/``sample_batch`` draw the AR process's
stationary marginal.

``stream`` is the stateful part: it keeps one user population per (N, K)
size (large-scale gains, cycle counts and the envelope (x, y)) and
advances the envelope each time that size recurs,

    x' = corr * x + sqrt(1 - corr^2) * eps,   eps ~ N(0, 1)   (same for y),

so successive requests of one size correlate (the power gain with
coefficient ``corr^2``) while every single draw keeps the stationary law.
"""
from __future__ import annotations

import math

import torch

from ..core.types import SystemParams
from ..device import resolve_device
from .base import (
    DEFAULT_STREAM_BBAR,
    DEFAULT_STREAM_SIZES,
    ScenarioFamily,
    _validate_stream,
    generator,
    large_scale_db,
    pick,
    register,
    table1_population,
    uniform,
)


def _envelope_gain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Power gain of the complex envelope (x + iy)/sqrt(2): exp(1) marginal."""
    return (x * x + y * y) / 2.0


def _params(pl_shadow_db, x, y, c, lead, *, device, N, K, B, eta, q, **population) -> SystemParams:
    gain_lin = 10.0 ** (-pl_shadow_db[..., None] / 10.0) * _envelope_gain(x, y)
    return SystemParams(
        g=gain_lin,
        c=c,
        **table1_population(N, lead=lead, device=device, **population),
        N=N,
        K=K,
        B=B,
        q=q,
        eta=eta,
    )


class GaussMarkov(ScenarioFamily):
    name = "gauss_markov"

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
        c_lo: float = 1e4,
        c_hi: float = 3e4,
        q: int = 2,
        **population,
    ) -> SystemParams:
        """Stationary draws of shape ``lead`` (the AR process's marginal law).
        ``population`` takes `table1_population`'s keywords."""
        dev_shape = tuple(lead) + (N,)
        pl_shadow_db = large_scale_db(gen, dev_shape, radius_m, shadowing_db, device)
        x, y = torch.randn(
            (2,) + dev_shape + (K,), generator=gen, device=device, dtype=torch.float32
        )
        c = uniform(gen, dev_shape, c_lo, c_hi, device)
        return _params(pl_shadow_db, x, y, c, lead, device=device, N=N, K=K, B=B,
                       eta=eta, q=q, **population)

    def stream(
        self,
        seed,
        n_requests: int,
        *,
        sizes=DEFAULT_STREAM_SIZES,
        bbar: float = DEFAULT_STREAM_BBAR,
        corr: float = 0.9,
        device="cuda",
        radius_m: float = 500.0,
        shadowing_db: float = 8.0,
        eta: int = 10,
        c_lo: float = 1e4,
        c_hi: float = 3e4,
        q: int = 2,
        **population,
    ) -> list[SystemParams]:
        """Time-correlated request stream: one persistent user population per
        (N, K) size, AR(1)-advanced each time that size recurs (module doc).
        The size of each request is a uniform pick from ``sizes``, as in the
        default stream."""
        sizes = tuple(sizes)
        _validate_stream(n_requests, sizes)
        if not 0.0 <= corr < 1.0:
            raise ValueError(f"corr must be in [0, 1), got {corr}")
        innov = math.sqrt(1.0 - corr * corr)
        dev = resolve_device(device)
        gen = generator(seed, dev)
        normal = lambda n, k: torch.randn((2, n, k), generator=gen, device=dev, dtype=torch.float32)

        # per-(N, K) persistent population: (pl_shadow_db, c, x, y)
        state: dict[tuple[int, int], tuple] = {}
        out = []
        for _ in range(n_requests):
            n, k = sizes[pick(gen, len(sizes), dev)]
            if (n, k) not in state:
                pls = large_scale_db(gen, (n,), radius_m, shadowing_db, dev)
                c = uniform(gen, (n,), c_lo, c_hi, dev)
                x, y = normal(n, k)
            else:
                pls, c, x, y = state[(n, k)]
                ex, ey = normal(n, k)
                x = corr * x + innov * ex
                y = corr * y + innov * ey
            state[(n, k)] = (pls, c, x, y)
            out.append(_params(pls, x, y, c, (), device=dev, N=n, K=k, B=bbar * k,
                               eta=eta, q=q, **population))
        return out


FAMILY = register(GaussMarkov())
