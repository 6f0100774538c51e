"""Batched serving driver: a continuous-batching decode loop over a request
queue, with per-step latency stats.

Counterpart of `repro.launch.serve`:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b --smoke \
      --requests 8 --max-new 16 [--device cpu]

Prompts are ingested through the decode path, position by position, and
tokens are chosen greedily (argmax), as in the reference. The loop advances
one global position for all slots, and a refilled slot inherits the old
slot's KV cache entries (the reference's semantics, ported as they are).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import smoke_variant


class ServeLoop:
    """Fixed-slot continuous batching: finished sequences are replaced by
    queued requests; every slot advances one token per step."""

    def __init__(self, cfg, params: M.LM, batch_slots: int, max_len: int, mesh=None):
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet: ROADMAP.md §1, item 11b")
        self.cfg, self.params = cfg, params
        self.max_len = max_len
        self.device = params.device
        self.cache = M.init_cache(cfg, batch_slots, max_len, self.device)
        self.slots = batch_slots

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
            logits, self.cache = M.decode_step(self.params, self.cfg, token, pos, self.cache)
            last = logits[:, 0, :]
            if greedy:
                nxt = torch.argmax(last, dim=-1)
            else:
                probs = torch.softmax(last.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            tok = nxt.tolist()               # waits for the step on the device
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
