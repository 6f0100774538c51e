"""The paper's Table-I scenario law (Section V), drawn from a seed on the
device: a frozen copy of `repro_torch/scenarios/iid_rayleigh.py:IidRayleigh.draw`
(:21-63) and its helpers `scenarios/base.py:table1_population`, `uniform`,
`large_scale_db`, `rayleigh_power` (:30-83), so the scenarios do not move
with the program. Path loss 128.1 + 37.6 log10(dist_km) dB with log-normal
shadowing, devices uniform in a disc, unit-mean exponential fading per
subcarrier; the homogeneous Table-I population, whose FL upload ``D_bits``
the traffic sets from the model the FL job trains.
"""
from __future__ import annotations

import math

import torch

#: N0 = -174 dBm/Hz in W/Hz
N0_W_PER_HZ = 10.0 ** ((-174.0 - 30.0) / 10.0)


def draw(gen: torch.Generator, batch: int, law: dict, D_bits: float, device) -> dict:
    """``batch`` i.i.d. scenarios of ``law`` (a traffic file's ``scenario``):
    float32 tensors g (batch, N, K), c, d, D, C, p_max, f_max, t_sc_max
    (batch, N), and the meta scalars N, K, B, N0, xi, eta, q."""
    N, K = law["N"], law["K"]
    shape = (batch, N)
    u = lambda s, lo, hi: lo + (hi - lo) * torch.rand(s, generator=gen, device=device)
    # devices uniform in a disc: r = sqrt(U) * radius
    dist_km = torch.sqrt(u(shape, 1e-3, 1.0)) * law["radius_m"] / 1000.0
    pl_db = 128.1 + 37.6 * torch.log10(dist_km)
    pl_db = pl_db + law["shadowing_db"] * torch.randn(shape, generator=gen, device=device)
    ray = torch.empty(shape + (K,), device=device).exponential_(generator=gen)
    g = 10.0 ** (-pl_db[..., None] / 10.0) * ray
    c = u(shape, law["c_lo"], law["c_hi"])
    ones = torch.ones(shape, device=device)
    p_max_w = 10.0 ** ((law["p_max_dbm"] - 30.0) / 10.0)
    return dict(
        g=g, c=c, d=law["d_samples"] * ones, D=float(D_bits) * ones,
        C=law["C_round_bits"] * law["L_rounds"] * ones, p_max=p_max_w * ones,
        f_max=law["f_max_hz"] * ones, t_sc_max=law["t_sc_max"] * ones,
        N=N, K=K, B=float(law["B_hz"]), N0=N0_W_PER_HZ, xi=float(law["xi"]),
        eta=int(law["eta"]), q=int(law["q"]),
    )


def tree_bits(param_count: int, bits_per_param: int) -> float:
    """The FL upload D_n of a job that trains a model of ``param_count``
    parameters: every parameter at ``bits_per_param`` bits, as the FL driver
    prices a round (fl/federated.py:158, core/bits.py)."""
    return float(param_count * bits_per_param)


def check_law(law: dict) -> None:
    """Refuse a law the scenarios cannot hold (K >= N, positive sizes)."""
    if law["K"] < law["N"] or min(law["N"], law["K"]) < 1:
        raise ValueError(f"scenario law needs K >= N >= 1, got N={law['N']}, K={law['K']}")
    if not math.isfinite(law["B_hz"]) or law["B_hz"] <= 0:
        raise ValueError(f"scenario law needs a positive bandwidth, got {law['B_hz']}")
