"""Synthetic data pipelines (no external datasets).

Images: structured scenes of coloured rectangles on a smooth background
with texture noise, so the compression rate really trades off
reconstruction quality. Tokens: Zipf-distributed LM streams with Markov
bigram structure, so cross-entropy really falls during the training runs.

Counterpart of `repro.data.synthetic`, drawn from explicit
`torch.Generator`s with the reference's laws (not its draws: JAX's threefry
streams cannot be reproduced in torch); images in NCHW for the port's codec.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
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


def make_bigram_table(gen: torch.Generator, vocab: int, concentration: float = 0.5) -> torch.Tensor:
    """(vocab, vocab) float32 bigram logits on ``gen``'s device: row ``a``
    is the next-token logits after ``a``, a Zipf prior -log(rank) plus
    ``concentration`` x standard Gumbel noise per entry. (vocab^2 float32:
    92 GB at Qwen2.5-3B's vocab, so only cut vocabularies build it.)"""
    dev = gen.device
    base = -torch.log(torch.arange(1, vocab + 1, dtype=torch.float32, device=dev))
    # standard Gumbel as `jax.random.gumbel` draws it: -log(-log(u)), u
    # uniform in [tiny, 1), so no entry is infinite
    u = torch.rand((vocab, vocab), generator=gen, device=dev).clamp_min_(torch.finfo(torch.float32).tiny)
    return base[None, :] + -torch.log(-torch.log(u)) * concentration


def token_batch(gen: torch.Generator, table: torch.Tensor, batch: int, seq: int) -> torch.Tensor:
    """(batch, seq + 1) int64 tokens (inputs and the shifted labels) from the
    bigram chain of ``table``: the first token of a row drawn from
    softmax(table[0]), each next one from softmax(table[previous])."""
    probs = torch.softmax(table, dim=-1)
    tok = torch.multinomial(probs[0].expand(batch, -1), 1, generator=gen)[:, 0]
    out = [tok]
    for _ in range(seq):
        tok = torch.multinomial(probs[tok], 1, generator=gen)[:, 0]
        out.append(tok)
    return torch.stack(out, dim=1)


def token_stream(gen: torch.Generator, vocab: int, batch: int, seq: int) -> Iterator[torch.Tensor]:
    """Successive `token_batch`es of one bigram table, all drawn from ``gen``."""
    table = make_bigram_table(gen, vocab)
    while True:
        yield token_batch(gen, table, batch, seq)


def partition_clients(gen: torch.Generator, n_clients: int, pool: int = 1024,
                      alpha: float = 0.5) -> np.ndarray:
    """Dirichlet(alpha) non-IID client shares of a pool of ``pool`` samples,
    each floored to an integer and raised to at least 16 (the FL driver's
    d_n), as an int32 numpy array."""
    g = torch._standard_gamma(torch.full((n_clients,), alpha, dtype=torch.float32,
                                         device=gen.device), generator=gen)
    share = g / torch.sum(g)
    return np.maximum((share * pool).to(torch.int32).cpu().numpy(), 16)
