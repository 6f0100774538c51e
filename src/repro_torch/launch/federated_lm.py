"""Federated fine-tuning of an LM backbone with allocator-driven compression.

Counterpart of the reference's ``examples/federated_lm.py``, with the same
flags plus ``--device`` (the card unless ``--device cpu``). Any ported
``--arch`` works (its smoke variant unless ``--full-size``); each round,
Alg. A2 chooses the compression rate rho, which sparsifies the clients'
uploaded updates (top-|rho| magnitude), and the round's wireless energy and
delay are simulated from the allocation. Client batches are drawn from one
bigram chain (`data.synthetic`); ``--full-size`` builds its (vocab, vocab)
table, which a full vocabulary does not fit (92 GB at Qwen2.5-3B's), as in
the reference. Exits 1 unless the last round's loss is below the first's.

  PYTHONPATH=src python -m repro_torch.launch.federated_lm --arch qwen2_5_3b --rounds 8
  PYTHONPATH=src python -m repro_torch.launch.federated_lm --device cpu --rounds 2
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..configs.registry import get_config
from ..data.synthetic import make_bigram_table, token_batch
from ..device import resolve_device
from ..fl import FLConfig, run_fl
from ..models import model as M
from ..models.config import ModelConfig, smoke_variant

#: the example's client batch
BATCH = 4


def fl_config(rounds: int = 8, clients: int = 4) -> FLConfig:
    """The example's FL settings: 4 subcarriers a client, 2 local SGD steps
    at lr 0.02, compression on, the allocator at its default depth."""
    return FLConfig(rounds=rounds, n_clients=clients, n_subcarriers=4 * clients,
                    local_steps=2, lr=0.02, compress=True)


def run(cfg: ModelConfig, fl_cfg: FLConfig, seq: int = 64, device="cuda", backend=None,
        seed: int = 0):
    """The example's computation: ``cfg``'s random parameters (from
    ``seed``) trained by `run_fl` on bigram-chain batches of ``seq`` tokens;
    returns (params tree, history)."""
    dev = resolve_device(device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(seed)).tree
    table = make_bigram_table(torch.Generator(dev).manual_seed(7), cfg.vocab)

    def loss_fn(p, batch, gen):
        return M.loss_fn(p, cfg, batch)

    def client_batch(gen, i):
        toks = token_batch(gen, table, BATCH, seq)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return run_fl(seed, params, loss_fn, client_batch, fl_cfg, backend=backend)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = smoke_variant(cfg)
    _, hist = run(cfg, fl_config(args.rounds, args.clients), args.seq, args.device)

    print(f"\n{'round':>5s} {'loss':>8s} {'rho':>5s} {'energy J':>9s} {'T_FL s':>7s}")
    for i, h in enumerate(hist):
        print(f"{i:5d} {h.loss:8.4f} {h.rho:5.2f} {h.energy:9.3f} {h.t_fl:7.3f}")
    if not hist[-1].loss < hist[0].loss:
        print("FL did not reduce loss", file=sys.stderr)
        return 1
    print("\nFL reduced loss:", round(hist[0].loss - hist[-1].loss, 4),
          "| total upload:",
          f"{sum(h.upload_bits for h in hist)/8e6:.1f} MB (rho-compressed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
