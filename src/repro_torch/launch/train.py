"""The LM train step and a single-device training driver.

Counterpart of `repro.launch.train`: `build_train_step(cfg)` returns a
``(state, batch) -> (state, metrics)`` function: the loss (`models.model.
loss_fn`, remat per period, the plain sequence mixers) -> its gradients ->
global-norm clip -> AdamW (weight decay 0.01); metrics ``loss`` and
``grad_norm``. The state's parameters are the model's tree
(``models.model.LM.tree``: the reference's layout, each block's leaves
stacked over its stage's periods).

The step updates the state it is given in place and returns it: the
parameters and AdamW's two float32 moments of Qwen2.5-3B take 37 GB, and a
second copy of them would not fit beside the first on an 80 GB card (the
reference's jitted step leaves that to XLA's buffer donation). Each leaf is
clipped and updated in turn by the port's `optim.adamw` arithmetic, so the
float32 temporaries of the update are one leaf's. The clipped gradient is
float32, as the reference's is (a bfloat16 gradient times its float32
scale promotes in JAX).

Under a mesh (`launch.mesh`) the state's leaves are DTensors placed by
`parallel.sharding.param_specs` (`init_state(mesh=)`,
`bridge.lm_params_from_numpy(mesh=)`): each rank's gradients are its data
shard's share, summed over the data axes; the global norm is reduced over
the whole mesh (a sharded leaf's squares over its shards, a replicated
leaf's counted once); the AdamW update runs on each rank's local tensors,
a leaf at a time.

Run as a script for a short training run (on the card unless ``--device
cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b --smoke --steps 50
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..core.types import tree_leaves
from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig, smoke_variant
from ..optim.optimizers import OptState, adamw, clip_scale, global_norm, value_and_grad
from ..parallel import sharding as SH


class TrainState(NamedTuple):
    params: dict
    opt: OptState


def build_train_step(cfg: ModelConfig, mesh=None, lr: float = 3e-4, clip: float = 1.0,
                     use_kernel: bool = False):
    """The train step of ``cfg``. ``use_kernel`` is `loss_fn`'s: the kernels
    are forward only and raise under autograd, so only False trains. With
    ``mesh`` the state's leaves are DTensors on it (module docstring)."""
    _, opt_update = adamw(lr, weight_decay=0.01)

    def train_step(state: TrainState, batch):
        loss, grads = value_and_grad(
            lambda p: M.loss_fn(p, cfg, batch, mesh=mesh, use_kernel=use_kernel), state.params)
        if mesh is None:
            gnorm = global_norm(grads)
            local = lambda t: t
        else:
            grads = tree_leaves(grads)
            for i, p in enumerate(tree_leaves(state.params)):   # sum the data shares, a leaf at a time
                grads[i] = grads[i].redistribute(p.device_mesh, p.placements)
            gnorm = SH.global_norm(grads)
            local = lambda t: t.to_local()
        scale = clip_scale(gnorm, clip)
        opt = state.opt
        step = opt.step
        with torch.no_grad():
            for p, m, v, g in zip(*(map(local, tree_leaves(t)) for t in (state.params, opt.mu, opt.nu, grads)),
                                  strict=True):
                new_p, new = opt_update(g.float() * scale, OptState(step, m, v), p)
                p.copy_(new_p)
                m.copy_(new.mu)
                v.copy_(new.nu)
        return TrainState(state.params, OptState(step + 1, opt.mu, opt.nu)), {
            "loss": loss, "grad_norm": gnorm}

    return train_step


def init_state(cfg: ModelConfig, generator: torch.Generator, lr: float = 3e-4,
               mesh=None) -> TrainState:
    """Random parameters of the reference's law (`models.model.init_params`)
    on the generator's device, as a tree, and AdamW's zero state; with
    ``mesh`` DTensors placed by `parallel.sharding.param_specs` (each
    rank's block a view of the tree it drew)."""
    params = M.init_params(cfg, generator).tree
    if mesh is not None:
        params = SH.shard_tree(mesh, SH.param_specs(params), params)
    opt_init, _ = adamw(lr, weight_decay=0.01)
    return TrainState(params, opt_init(params))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs.registry import get_config
    from ..data.synthetic import token_stream

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(cfg, gen, args.lr)
    step_fn = build_train_step(cfg, lr=args.lr)

    stream = token_stream(gen, cfg.vocab, args.batch, args.seq)
    t0 = time.time()
    for i in range(args.steps):
        toks = next(stream)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, metrics = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(
                f"step {i:4d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({time.time()-t0:.1f}s)"
            )
    print("done")


if __name__ == "__main__":
    main()
