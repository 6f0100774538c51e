"""The paper's Section-V scenario: i.i.d. Rayleigh block fading.

Counterpart of `repro.scenarios.iid_rayleigh`, the same law drawn with a
`torch.Generator`: path loss 128.1 + 37.6 log10(dist_km) dB with 8 dB
log-normal shadowing, devices uniform in a 500 m disc, unit-mean
exponential (Rayleigh power) fading per subcarrier, N0 = -174 dBm/Hz,
B = 20 MHz, K = 50, and the Table-I device population.
"""
from __future__ import annotations

import torch

from ..core.types import SystemParams
from .base import (
    ScenarioFamily, large_scale_db, rayleigh_power, register, table1_population, uniform,
)


class IidRayleigh(ScenarioFamily):
    name = "iid_rayleigh"

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
        """Draw scenarios of shape ``lead`` with the paper's Table-I defaults."""
        dev_shape = tuple(lead) + (N,)
        pl_shadow_db = large_scale_db(gen, dev_shape, radius_m, shadowing_db, device)
        # small-scale Rayleigh fading per subcarrier (block fading in slot t)
        ray = rayleigh_power(gen, dev_shape + (K,), device)
        gain_lin = 10.0 ** (-pl_shadow_db[..., None] / 10.0) * ray
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


FAMILY = register(IidRayleigh())
