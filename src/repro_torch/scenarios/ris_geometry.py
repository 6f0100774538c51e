"""RIS-assisted geometric channel family (Federated-Edge-AI-for-6G setup).

Counterpart of `repro.scenarios.ris_geometry`, the same law drawn with a
`torch.Generator`. The large-scale gain comes from explicit Cartesian
geometry: a BS at (-50, 0, 10) m, a RIS at (0, 0, 10) m with ``n_ris_ele``
elements of side ``lambda/10``, and users uniform on a ground disc around
the RIS. Per-user gain is the sum of

* the direct BS->user path, ``G_bs * G_user * (lambda / 4 pi d)^alpha``
  with ``alpha_direct`` typically > 2 (blocked/NLoS), and
* the RIS cascade, ``G_bs * G_ris * G_user *
  (n_ris * A_ele / lambda)^2 / (4 pi d_bs_ris d_ris_user)^2``.

The geometry is float32, as the reference's: at the disc's edge (d_ris_user
about 100 m) the cascade is about 7e-12 and its denominator about 4e9, far
from float32's limits. Small-scale Rayleigh fading stays i.i.d. per
subcarrier, and the device population is the paper's Table-I
(`table1_population`).
"""
from __future__ import annotations

import math

import torch

from ..core.types import SystemParams
from .base import ScenarioFamily, rayleigh_power, register, table1_population, uniform

#: speed of light, m/s
_C0 = 3e8


def large_scale_gain(
    r: torch.Tensor,
    theta: torch.Tensor,
    *,
    fc_hz: float = 915e6,
    alpha_direct: float = 3.5,
    n_ris_ele: int = 16,
    bs_gain_db: float = 5.0,
    ris_gain_db: float = 5.0,
    user_gain_db: float = 0.0,
    bs_xyz: tuple[float, float, float] = (-50.0, 0.0, 10.0),
    ris_xyz: tuple[float, float, float] = (0.0, 0.0, 10.0),
) -> torch.Tensor:
    """Direct path plus RIS cascade (float32) of users on the ground at
    distance ``r`` [m] and angle ``2 pi theta`` from the RIS's foot."""
    lam = _C0 / fc_hz
    g_bs = 10.0 ** (bs_gain_db / 10.0)
    g_ris = 10.0 ** (ris_gain_db / 10.0)
    g_user = 10.0 ** (user_gain_db / 10.0)
    bs = torch.tensor(bs_xyz, dtype=torch.float32, device=r.device)
    ris = torch.tensor(ris_xyz, dtype=torch.float32, device=r.device)
    users = torch.stack(
        [ris[0] + r * torch.cos(2 * math.pi * theta),
         ris[1] + r * torch.sin(2 * math.pi * theta),
         torch.zeros_like(r)],
        dim=-1,
    )

    d_direct = torch.linalg.vector_norm(users - bs, dim=-1)
    d_bs_ris = torch.linalg.vector_norm(ris - bs)
    d_ris_user = torch.linalg.vector_norm(users - ris, dim=-1)

    direct = g_bs * g_user * (lam / (4.0 * math.pi * d_direct)) ** alpha_direct
    aperture = n_ris_ele * (lam / 10.0) ** 2  # element side = lambda/10
    cascade = (
        g_bs * g_ris * g_user
        * (aperture / lam) ** 2
        / (4.0 * math.pi * d_bs_ris * d_ris_user) ** 2
    )
    return direct + cascade


class RisGeometry(ScenarioFamily):
    name = "ris_geometry"

    def draw(
        self,
        gen: torch.Generator,
        lead: tuple,
        *,
        device,
        N: int = 10,
        K: int = 50,
        B: float = 20e6,
        radius_m: float = 100.0,
        eta: int = 10,
        c_lo: float = 1e4,
        c_hi: float = 3e4,
        q: int = 2,
        fc_hz: float = 915e6,
        alpha_direct: float = 3.5,
        n_ris_ele: int = 16,
        bs_gain_db: float = 5.0,
        ris_gain_db: float = 5.0,
        user_gain_db: float = 0.0,
        bs_xyz: tuple[float, float, float] = (-50.0, 0.0, 10.0),
        ris_xyz: tuple[float, float, float] = (0.0, 0.0, 10.0),
        **population,
    ) -> SystemParams:
        dev_shape = tuple(lead) + (N,)
        # users uniform on the ground disc centred under the RIS
        u = uniform(gen, dev_shape, 0.0, 1.0, device)
        theta = uniform(gen, dev_shape, 0.0, 1.0, device)
        r = torch.sqrt(torch.clamp_min(u, 1e-6)) * radius_m
        large_scale = large_scale_gain(
            r, theta, fc_hz=fc_hz, alpha_direct=alpha_direct, n_ris_ele=n_ris_ele,
            bs_gain_db=bs_gain_db, ris_gain_db=ris_gain_db, user_gain_db=user_gain_db,
            bs_xyz=bs_xyz, ris_xyz=ris_xyz,
        )

        # small-scale Rayleigh per subcarrier, as in iid_rayleigh
        gain_lin = large_scale[..., None] * rayleigh_power(gen, dev_shape + (K,), device)
        c = uniform(gen, dev_shape, c_lo, c_hi, device)

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


FAMILY = register(RisGeometry())
