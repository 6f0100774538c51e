"""Synthetic images (no external datasets): structured scenes of coloured
rectangles on a smooth background with texture noise, so the compression
rate really trades off reconstruction quality.

Counterpart of `repro.data.synthetic`'s images, drawn from a
`torch.Generator` with the reference's law (not its draws: JAX's threefry
streams cannot be reproduced in torch), in NCHW for the port's codec. The
token streams and `partition_clients` belong to training (ROADMAP.md §1,
item 11).
"""
from __future__ import annotations

from typing import Iterator

import torch


def image_batch(gen: torch.Generator, batch: int, size: int = 32, channels: int = 3) -> torch.Tensor:
    """(B, C, H, W) float32 images in [-1, 1] on ``gen``'s device.

    Per image: a background linear in the row and column coordinates
    (coefficients N(0, 0.4^2) per channel); three rectangles, later over
    earlier, each with a corner uniform in [0, size - 8), sides uniform in
    [4, size // 2) and a colour uniform in [-1, 1) per channel; N(0, 0.05^2)
    noise per pixel; clipped to [-1, 1].
    """
    dev = gen.device
    coef = 0.4 * torch.randn((batch, 2, channels), generator=gen, device=dev)
    grid = torch.arange(size, device=dev, dtype=torch.float32) / size
    yy, xx = grid[:, None], grid[None, :]
    bg = coef[:, 0, :, None, None] * yy + coef[:, 1, :, None, None] * xx    # (B, C, H, W)

    corner = torch.randint(0, size - 8, (batch, 3, 2), generator=gen, device=dev)
    sides = torch.randint(4, size // 2, (batch, 3, 2), generator=gen, device=dev)
    colour = 2.0 * torch.rand((batch, 3, channels), generator=gen, device=dev) - 1.0
    rows = torch.arange(size, device=dev)
    fg = torch.zeros((batch, channels, size, size), device=dev)
    for i in range(3):
        (y0, x0), (h, w) = corner[:, i].T, sides[:, i].T
        in_y = (rows >= y0[:, None]) & (rows < (y0 + h)[:, None])          # (B, H)
        in_x = (rows >= x0[:, None]) & (rows < (x0 + w)[:, None])          # (B, W)
        mask = (in_y[:, :, None] & in_x[:, None, :])[:, None]              # (B, 1, H, W)
        fg = torch.where(mask, colour[:, i, :, None, None], fg)

    noise = 0.05 * torch.randn((batch, channels, size, size), generator=gen, device=dev)
    return torch.clamp(bg + fg + noise, -1.0, 1.0)


def image_stream(gen: torch.Generator, batch: int, size: int = 32) -> Iterator[torch.Tensor]:
    """Successive `image_batch`es drawn from one generator."""
    while True:
        yield image_batch(gen, batch, size)
