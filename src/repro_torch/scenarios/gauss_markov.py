"""Gauss-Markov (AR(1)) time-correlated fading family: its stationary law.

Counterpart of `repro.scenarios.gauss_markov`, the same law drawn with a
`torch.Generator`. Each subcarrier's small-scale fading is the complex
envelope ``h = (x + iy) / sqrt(2)`` of two standard normals, so the power
gain ``|h|^2 = (x^2 + y^2) / 2`` has the exponential (Rayleigh-power)
marginal of `iid_rayleigh`; path loss, shadowing and the population are
`iid_rayleigh`'s. ``sample``/``sample_batch`` draw the AR process's
stationary marginal. The time-correlated ``stream`` (one fading state per
(N, K) size, advanced by ``x' = corr x + sqrt(1 - corr^2) eps``) belongs to
the serving slice and raises until then (ROADMAP.md §1, item 8).
"""
from __future__ import annotations

import torch

from ..core.types import SystemParams
from .base import ScenarioFamily, large_scale_db, register, table1_population, uniform


def _envelope_gain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Power gain of the complex envelope (x + iy)/sqrt(2): exp(1) marginal."""
    return (x * x + y * y) / 2.0


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
        p_max_dbm: float = 20.0,
        f_max_hz: float = 2e9,
        eta: int = 10,
        d_samples: float = 500.0,
        c_lo: float = 1e4,
        c_hi: float = 3e4,
        D_bits: float = 2.81e4,
        C_round_bits: float = 4.15e6,
        L_rounds: int = 10,
        t_sc_max: float = 20.0,
        q: int = 2,
    ) -> SystemParams:
        """Stationary draws of shape ``lead`` (the AR process's marginal law)."""
        dev_shape = tuple(lead) + (N,)
        pl_shadow_db = large_scale_db(gen, dev_shape, radius_m, shadowing_db, device)
        x, y = torch.randn(
            (2,) + dev_shape + (K,), generator=gen, device=device, dtype=torch.float32
        )
        gain_lin = 10.0 ** (-pl_shadow_db[..., None] / 10.0) * _envelope_gain(x, y)
        c = uniform(gen, dev_shape, c_lo, c_hi, device)
        return SystemParams(
            g=gain_lin,
            c=c,
            **table1_population(
                N, lead=lead, device=device, d_samples=d_samples, D_bits=D_bits,
                C_round_bits=C_round_bits, L_rounds=L_rounds, t_sc_max=t_sc_max,
                p_max_dbm=p_max_dbm, f_max_hz=f_max_hz,
            ),
            N=N,
            K=K,
            B=B,
            q=q,
            eta=eta,
        )


FAMILY = register(GaussMarkov())
