"""Batched serving driver: a continuous-batching decode loop over a request
queue, with per-step latency stats.

Counterpart of `repro.launch.serve`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b --smoke \
      --requests 8 --max-new 16 [--device cpu]

Prompts are ingested through the decode path, position by position, and
tokens are chosen greedily (argmax), as in the reference, or drawn from the
softmax by the Gumbel maximum (`parallel.collectives.pick`), as the
reference's `jax.random.categorical` draws. The loop advances one global
position for all slots, and a refilled slot inherits the old slot's KV
cache entries (the reference's semantics, ported as they are).

With ``mesh`` (`launch.mesh`) the cache is placed by
`parallel.sharding.cache_specs` (each rank allocates its block only) and
the next tokens are picked from the vocab-sharded logits without
gathering them: each shard's best (and, sampling, its Gumbel-perturbed
best) is compared across ``model``, and the data shards' rows across the
data axes.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import smoke_variant
from repro_torch.parallel import collectives as C


class ServeLoop:
    """Fixed-slot continuous batching: finished sequences are replaced by
    queued requests; every slot advances one token per step."""

    def __init__(self, cfg, params: M.LM, batch_slots: int, max_len: int, mesh=None):
        self.cfg, self.params, self.mesh = cfg, params, mesh
        self.max_len = max_len
        tree = params.tree if isinstance(params, M.LM) else params
        self.device = tree["embed"].device
        self.slots = batch_slots
        self.cache = M.init_cache(cfg, batch_slots, max_len, self.device, mesh=mesh)

    def step(self, token, pos: int):
        """One decode step of the (slots, 1) ``token`` at ``pos``: the
        logits (slots, 1, V), a DTensor under a mesh."""
        return M.decode_step(self.params, self.cfg, token, pos, self.cache, mesh=self.mesh)[0]

    def pick(self, logits, greedy=True, generator=None) -> list[int]:
        """Each slot's next token: the argmax of its last logits, or with
        ``greedy=False`` a draw from their softmax (``generator``), by
        `parallel.collectives.pick` with or without a mesh."""
        return C.pick(logits, greedy, generator)

    def run(self, requests: list[list[int]], max_new: int, greedy=True, generator=None):
        """requests: token lists. Returns (dict req_idx -> generated tokens,
        stats). ``greedy=False`` samples from the softmax with ``generator``
        (a `torch.Generator` on the model's device)."""
        queue = list(enumerate(requests))
        active = [None] * self.slots        # [req_idx, prompt, n_emitted, out]
        results = {}
        tok = [0] * self.slots
        pos = 0
        stats = {"steps": 0, "step_times": []}

        def refill():
            for s in range(self.slots):
                if active[s] is None and queue:
                    idx, prompt = queue.pop(0)
                    active[s] = [idx, list(prompt), 0, []]

        refill()
        while any(a is not None for a in active) and pos < self.max_len - 1:
            feed = []
            for s in range(self.slots):
                a = active[s]
                if a is None:
                    feed.append(0)
                elif a[1]:                   # still ingesting the prompt
                    feed.append(a[1].pop(0))
                else:
                    feed.append(tok[s])
            t0 = time.perf_counter()
            token = torch.tensor(feed, dtype=torch.long, device=self.device)[:, None]
            tok = self.pick(self.step(token, pos), greedy, generator)   # waits for the step
            stats["step_times"].append(time.perf_counter() - t0)
            stats["steps"] += 1
            pos += 1
            for s in range(self.slots):
                a = active[s]
                if a is None:
                    continue
                if not a[1]:                 # prompt done -> emitting
                    a[3].append(tok[s])
                    a[2] += 1
                    if a[2] >= max_new:
                        results[a[0]] = a[3]
                        active[s] = None
            refill()
        for a in active:
            if a is not None:
                results[a[0]] = a[3]
        return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2_2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen)
    loop = ServeLoop(cfg, params, args.slots, max_len=256)

    prompts = torch.randint(0, cfg.vocab, (args.requests, 8), generator=gen, device=dev).tolist()
    t0 = time.perf_counter()
    results, stats = loop.run(prompts, args.max_new)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, {1e3*sum(stats['step_times'])/max(stats['steps'],1):.1f} ms/step)")


if __name__ == "__main__":
    main()
