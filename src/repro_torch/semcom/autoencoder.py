"""The paper's SemCom model (§III-A, §V-E): a CNN autoencoder in PyTorch.

Counterpart of `repro.semcom.autoencoder`. Encoder = conv5x5 -> [tanh,
conv] -> maxpool2x2 -> [tanh, conv] -> tanh; the decoder mirrors it
(nearest upsample + conv). AWGN is added between encoder and decoder in
training (the "channel"). The compression rate rho sets the bottleneck:
latent channels = ceil(rho * base_latent), and for rho <= 0.5 an extra 2x2
pooling stage halves the spatial dims, as in the paper.

The port computes in NCHW with OIHW filters (``torch.nn.functional.conv2d``,
padding k // 2: the reference's "SAME" for odd k); `repro_torch.bridge`
converts the reference's NHWC images and HWIO filters. The reference's
convolutions are XLA convolutions, not Pallas kernels, so library calls
are their counterpart here.

Randomness is explicit: `init_params` draws from a `torch.Generator`, and
the channel noise is a ``noise`` argument, either a generator to draw the
standard normal from or the draw itself (a tensor of the latent's shape),
never the global RNG. Loss = reconstruction MSE; PSNR and a [0, 1] proxy
accuracy re-fit A(rho) from FL-trained models.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.bits import tree_bits


class AEConfig(NamedTuple):
    image_size: int = 32
    channels: int = 3
    hidden: int = 16
    base_latent: int = 8          # latent channels at rho = 1
    rho: float = 1.0
    noise_std: float = 0.1        # AWGN channel sigma

    @property
    def latent_channels(self) -> int:
        return max(1, math.ceil(self.rho * self.base_latent))

    @property
    def extra_pool(self) -> bool:
        return self.rho <= 0.5    # paper: one more maxpool for rho <= 0.5

    @property
    def compressed_bits(self) -> float:
        """Size of the transmitted latent (float32 bits): the C_{n,l} proxy."""
        s = self.image_size // (4 if self.extra_pool else 2)
        return float(s * s * self.latent_channels * 32)


def _conv_init(gen: torch.Generator, k: int, cin: int, cout: int):
    """OIHW filter uniform in [-1/sqrt(k k cin), 1/sqrt(k k cin)) (the
    reference's law) and a zero bias, on the generator's device."""
    scale = 1.0 / math.sqrt(k * k * cin)
    u = torch.rand((cout, cin, k, k), generator=gen, device=gen.device, dtype=torch.float32)
    return {"w": (2.0 * u - 1.0) * scale, "b": torch.zeros(cout, device=gen.device)}


def init_params(gen: torch.Generator, cfg: AEConfig) -> dict:
    """Random codec parameters on ``gen``'s device."""
    lat = cfg.latent_channels
    return {
        "enc1": _conv_init(gen, 5, cfg.channels, cfg.hidden),
        "enc2": _conv_init(gen, 3, cfg.hidden, cfg.hidden),
        "enc3": _conv_init(gen, 3, cfg.hidden, lat),
        "dec1": _conv_init(gen, 3, lat, cfg.hidden),
        "dec2": _conv_init(gen, 3, cfg.hidden, cfg.hidden),
        "dec3": _conv_init(gen, 5, cfg.hidden, cfg.channels),
    }


def _conv(x, p):
    return F.conv2d(x, p["w"], p["b"], padding=p["w"].shape[-1] // 2)


def _pool(x):
    return F.max_pool2d(x, 2, 2)


def _upsample(x):
    """2x nearest neighbour, as an expand (its gradient is a sum, with no
    atomics on the card)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def _channel(z, noise_std: float, noise):
    """``z`` plus the AWGN channel: ``noise`` is None (no channel), a
    `torch.Generator` to draw the standard normal from, or that draw."""
    if noise is None:
        return z
    if isinstance(noise, torch.Generator):
        noise = torch.randn(z.shape, generator=noise, device=z.device, dtype=z.dtype)
    return z + noise_std * noise


def encode(params, cfg: AEConfig, x):
    h = torch.tanh(_conv(x, params["enc1"]))
    h = _pool(torch.tanh(_conv(h, params["enc2"])))
    if cfg.extra_pool:
        h = _pool(h)
    return torch.tanh(_conv(h, params["enc3"]))


def decode(params, cfg: AEConfig, z):
    h = torch.tanh(_conv(z, params["dec1"]))
    if cfg.extra_pool:
        h = _upsample(h)
    h = _upsample(torch.tanh(_conv(h, params["dec2"])))
    return torch.tanh(_conv(h, params["dec3"]))


def forward(params, cfg: AEConfig, x, noise=None):
    """Full codec pass; the AWGN channel applies when ``noise`` is given
    (training)."""
    return decode(params, cfg, _channel(encode(params, cfg, x), cfg.noise_std, noise))


def mse_loss(params, cfg: AEConfig, x, noise=None):
    return torch.mean(torch.square(forward(params, cfg, x, noise) - x))


def _psnr_of(m, peak: float):
    return 10.0 * torch.log10(peak**2 / torch.clamp_min(m, 1e-12))


def _proxy_of(p, lo: float, hi: float):
    return torch.clamp((p - lo) / (hi - lo), 0.0, 1.0)


def psnr(params, cfg: AEConfig, x, noise=None, peak: float = 2.0):
    return _psnr_of(mse_loss(params, cfg, x, noise), peak)


def proxy_accuracy(params, cfg: AEConfig, x, noise=None, lo: float = 8.0, hi: float = 28.0):
    """Map PSNR to a [0, 1] 'detection-accuracy' proxy (monotone,
    saturating), used only to re-fit A(rho)."""
    return _proxy_of(psnr(params, cfg, x, noise), lo, hi)


def param_bits(params) -> float:
    """Upload size D_n in bits (float32): feeds the allocator."""
    return tree_bits(params)


# -- runtime-rho codec --------------------------------------------------------
#
# `AEConfig.rho` bakes the bottleneck into the parameter shapes. The `_rho`
# family keeps the parameters at the rho = 1 shape (`base_latent` channels)
# and applies rho at run time: a channel mask keeps the first
# ceil(rho * base_latent) latent channels, and the extra pooling stage for
# rho <= 0.5 is a python branch (`extra_pool`), since it changes shapes.


def latent_mask(cfg: AEConfig, rho) -> torch.Tensor:
    """(base_latent,) 0/1 mask keeping ceil(rho * base_latent) channels (at
    least one), computed in float32 as the reference does."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    keep = torch.clamp(torch.ceil(rho * cfg.base_latent), 1.0, float(cfg.base_latent))
    return (torch.arange(cfg.base_latent, device=rho.device) < keep).to(torch.float32)


def encode_rho(params, cfg: AEConfig, x, rho, extra_pool: bool):
    """`encode` with a runtime rho: params of the rho = 1 shape; ``extra_pool``
    is the pooling-depth branch (True for rho <= 0.5)."""
    h = torch.tanh(_conv(x, params["enc1"]))
    h = _pool(torch.tanh(_conv(h, params["enc2"])))
    if extra_pool:
        h = _pool(h)
    z = torch.tanh(_conv(h, params["enc3"]))
    return z * latent_mask(cfg, rho).to(z.device)[:, None, None]


def decode_rho(params, cfg: AEConfig, z, extra_pool: bool):
    h = torch.tanh(_conv(z, params["dec1"]))
    if extra_pool:
        h = _upsample(h)
    h = _upsample(torch.tanh(_conv(h, params["dec2"])))
    return torch.tanh(_conv(h, params["dec3"]))


def forward_rho(params, cfg: AEConfig, x, rho, noise=None, extra_pool: bool | None = None):
    """Full codec pass at a runtime compression rate; ``extra_pool``
    defaults from ``rho`` (<= 0.5, as `AEConfig.extra_pool`)."""
    if extra_pool is None:
        extra_pool = float(rho) <= 0.5
    z = _channel(encode_rho(params, cfg, x, rho, extra_pool), cfg.noise_std, noise)
    return decode_rho(params, cfg, z, extra_pool)


def mse_loss_rho(params, cfg: AEConfig, x, rho, noise=None, extra_pool: bool | None = None):
    return torch.mean(torch.square(forward_rho(params, cfg, x, rho, noise, extra_pool) - x))


def proxy_accuracy_rho(params, cfg: AEConfig, x, rho, noise=None,
                       extra_pool: bool | None = None,
                       lo: float = 8.0, hi: float = 28.0, peak: float = 2.0):
    """`proxy_accuracy` through the runtime-rho codec: the per-round A(rho)
    measurement a `SemComJob` accumulates for the refit."""
    m = mse_loss_rho(params, cfg, x, rho, noise, extra_pool)
    return _proxy_of(_psnr_of(m, peak), lo, hi)


def compressed_bits_rho(cfg: AEConfig, rho: float) -> float:
    """Transmitted-latent bits at a runtime rho under the masked bottleneck,
    in python floats (agrees with ``AEConfig(rho=r).compressed_bits``)."""
    s = cfg.image_size // (4 if rho <= 0.5 else 2)
    lat = max(1, min(cfg.base_latent, math.ceil(rho * cfg.base_latent)))
    return float(s * s * lat * 32)
