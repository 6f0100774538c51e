"""The port's mesh paths on a (2, 2) ("data", "model") mesh of four CPU
processes (gloo), for `tests/test_torch_parallel.py`.

This module imports neither JAX nor the reference package: `mp.spawn`
re-imports it in each child. The test writes the cases (numpy inputs) to
``<dir>/cases.pkl``; every rank runs every case, and rank 0 writes the
results, gathered to whole arrays, to ``<dir>/out.pkl``:

    python tests/torch_mesh_worker.py <dir>

With ``--fake`` the cases run in this one process on a fake process group
(no communication; `repro_torch.launch.dryrun`'s), counted by
`repro_torch.launch.op_cost.OpCost`:

    python tests/torch_mesh_worker.py --fake <dir>

With ``--cuda-ep`` two processes, one a card, run expert-parallel
`moe_ffn` on a (1, 2) NCCL mesh and hold it against the reference's
semantics computed on one card (each expert shard's `moe_ffn_local`
``expert_slice``, summed, then the dense residual); rank 0 writes
``{"max_abs_err", "scale"}`` to ``<dir>/out.pkl``:

    python tests/torch_mesh_worker.py --cuda-ep <dir>
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def _np(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().float().cpu().numpy()


def _cfg(arch, cut):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.config import smoke_variant

    return smoke_variant(get_config(arch)).scaled(**cut)


def _batch(arrays):
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.to(torch.bfloat16) if k in ("frame_embeds", "patch_embeds") else t
    return out


def case_ce(mesh, c):
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import model as M

    logits = torch.from_numpy(c["logits"]).requires_grad_(True)
    labels = torch.from_numpy(c["labels"])
    with CommDebugMode() as comm:
        loss = M._sharded_cross_entropy(logits, labels, mesh)
        loss.backward()
    # each rank's gradient is its own block: the blocks sum to the whole
    grad = logits.grad.clone()
    dist.all_reduce(grad)
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    return {"loss": float(loss), "grad": grad.numpy(), "comm": counts}


def case_moe(mesh, c):
    from repro_torch.core.types import tree_map
    from repro_torch.models import moe
    from repro_torch.parallel import collectives as C, sharding as SH

    cfg = _cfg(c["arch"], c["cut"])
    p = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
             {kk: torch.from_numpy(vv) for kk, vv in v.items()}) for k, v in c["params"].items()}
    specs = SH.param_specs(p)
    if cfg.moe_2d:
        specs.update({"w_gate": ("model", None, "data"), "w_up": ("model", None, "data"),
                      "w_down": ("model", "data", None)})
    p = SH.shard_tree(mesh, specs, p)
    par = C.Par(mesh)
    local = tree_map(lambda t: t.to_local(), p)
    x = torch.from_numpy(c["x"])
    out, aux = moe.moe_ffn(local, cfg, C.slice_data(x, par), mesh=mesh)
    whole = C._all_gather(out, par, par.data_dims, 0)
    return {"out": whole.numpy(), "aux": float(aux)}


def case_prefill(mesh, c):
    from repro_torch import bridge
    from repro_torch.models import model as M

    cfg = _cfg(c["arch"], c["cut"])
    params = bridge.lm_params_from_numpy(c["params"], cfg, device="cpu", mesh=mesh)
    logits = M.prefill(params, cfg, _batch(c["batch"]), mesh=mesh)
    return {"logits": _np(logits)}


def case_serve(mesh, c):
    from repro_torch import bridge
    from repro_torch.launch.serve import ServeLoop

    cfg = _cfg(c["arch"], c["cut"])
    params = bridge.lm_params_from_numpy(c["params"], cfg, device="cpu", mesh=mesh)
    loop = ServeLoop(cfg, params, c["slots"], c["max_len"], mesh=mesh)
    results, _ = loop.run([list(r) for r in c["requests"]], c["max_new"])
    # sampling: the Gumbel maximum over the vocab shards, alike on every rank
    loop = ServeLoop(cfg, params, c["slots"], c["max_len"], mesh=mesh)
    sampled, _ = loop.run([list(r) for r in c["requests"]], c["max_new"], greedy=False,
                          generator=torch.Generator().manual_seed(0))
    every = [None] * WORLD
    dist.all_gather_object(every, sampled)
    return {"results": results, "sampled": sampled, "sampled_alike": all(e == sampled for e in every)}


def _fsdp_specs(specs, tree):
    """The dry run's FSDP rule at smoke width: 'data' on the first free
    dimension of a stacked layer leaf, after its period axis, that the
    data axis divides (`models.model` gathers it when the layer runs)."""
    from repro_torch.parallel import sharding as SH

    def leaf(path, x, spec):
        dims = list(spec) + [None] * (x.ndim - len(spec))
        if path[0] != "stages" or x.ndim < 3 or "data" in dims:
            return spec
        for i in range(1, x.ndim):
            if dims[i] is None and x.shape[i] % 2 == 0:
                dims[i] = "data"
                return tuple(dims)
        return spec

    return SH._map_with_path(leaf, tree, specs)


def case_train(mesh, c):
    """One train step from the reference's initial state: the loss, the
    grad_norm, the new parameters and the first moments (mu = 0.1 x the
    clipped gradient). With ``fsdp`` the layers' leaves are also sharded
    on 'data' (`_fsdp_specs`)."""
    from types import SimpleNamespace

    from repro_torch import bridge
    from repro_torch.core.types import tree_leaves
    from repro_torch.launch import train as T
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel import sharding as SH

    cfg = _cfg(c["arch"], c["cut"])
    if c.get("fsdp"):
        tree = bridge.lm_params_from_numpy(c["params"], cfg, device="cpu").tree
        params = SH.shard_tree(mesh, _fsdp_specs(SH.param_specs(tree), tree), tree)
        opt = adamw(c["lr"])[0](params)
        fsdp = sum(any(p.is_shard() for p in x.placements[:1]) for x in tree_leaves(params))
    else:
        params = bridge.lm_params_from_numpy(c["params"], cfg, device="cpu", mesh=mesh)
        zeros = _zeros(c["params"])
        opt = bridge.opt_state_from_numpy(SimpleNamespace(step=0, mu=zeros, nu=zeros), cfg, "cpu", mesh)
        fsdp = 0
    state = T.TrainState(params, opt)
    step = T.build_train_step(cfg, mesh=mesh, lr=c["lr"])
    state, metrics = step(state, _batch(c["batch"]))
    params, mu = {}, {}
    SH._map_with_path(lambda path, x: params.__setitem__(path, _np(x)), state.params)
    SH._map_with_path(lambda path, x: mu.__setitem__(path, _np(x)), state.opt.mu)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "params": params,
            "mu": mu, "fsdp_leaves": fsdp}


def case_product(_mesh, c):
    """x (64, 256) sharded on its columns, w (256, 128) on its rows, over a
    4-way axis: the partial products' all-reduce."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import op_cost
    from repro_torch.parallel import collectives as C

    par = C.Par(DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",)))
    x, w = torch.randn(64, 256), torch.randn(256, 128)
    with op_cost.OpCost() as cost:
        C.reduce(C.split(x, par) @ C.split(w, par, 0), par)
    return cost.as_dict()


def case_train_cost(mesh, c):
    """A smoke train step's per-device cost, traced on fake tensors."""
    from repro_torch.launch import dryrun

    cfg = _cfg(c["arch"], {})
    return dryrun.lower_pair(cfg, "train_4k", mesh, batch=c["batch"], seq=c["seq"])[0]


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return np.zeros_like(tree, dtype=np.float32)


CASES = {"ce": case_ce, "moe": case_moe, "prefill": case_prefill, "serve": case_serve,
         "train": case_train, "product": case_product, "train_cost": case_train_cost}


def _run_cases(mesh, workdir):
    with open(os.path.join(workdir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, c in cases.items():
        try:
            out[name] = CASES[c["kind"]](mesh, c)
        except Exception as e:  # noqa: BLE001 -- reported to the test, which fails on it
            import traceback

            out[name] = {"error": f"{type(e).__name__}: {e}\n{traceback.format_exc()[-3000:]}"}
    return out


def _run(rank, workdir):
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=WORLD)
    try:
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(2, 2), mesh_dim_names=("data", "model"))
        out = _run_cases(mesh, workdir)
        if rank == 0:
            with open(os.path.join(workdir, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _run_cuda_ep(rank, workdir):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.types import tree_map
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as SH

    torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(workdir, "store"), 2)
    dist.init_process_group("nccl", store=store, rank=rank, world_size=2)
    try:
        mesh = DeviceMesh("cuda", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
        cfg = _cfg("arctic_480b", dict(n_experts=4, top_k=2))
        gen = torch.Generator().manual_seed(0)
        p = tree_map(lambda t: t.cuda(), moe.init_moe_params(gen, cfg, torch.float32))
        x = torch.randn((4, 8, cfg.d_model), generator=gen).cuda()
        local = tree_map(lambda t: t.to_local(), SH.shard_tree(mesh, SH.param_specs(p), p))
        out, _ = moe.moe_ffn(local, cfg, x, mesh=mesh)
        if rank == 0:
            flat = x.reshape(-1, cfg.d_model)
            experts = {k: v for k, v in p.items() if k not in ("shared", "dense_res")}
            want = sum(moe.moe_ffn_local({k: (v[lo:lo + 2] if k != "router" else v) for k, v in experts.items()},
                                         cfg, flat, expert_slice=(lo, 2), n_total_experts=4)[0]
                       for lo in (0, 2))
            want = (want + moe.dense_ffn(p["dense_res"], cfg, flat)).reshape(out.shape)
            with open(os.path.join(workdir, "out.pkl"), "wb") as f:
                pickle.dump({"max_abs_err": float((out - want).abs().max()),
                             "scale": float(want.abs().max())}, f)
    finally:
        dist.destroy_process_group()


def _run_fake(workdir):
    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    out = _run_cases(dryrun.fake_mesh((2, 2)), workdir)
    with open(os.path.join(workdir, "out.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    sys.path.insert(0, os.path.abspath(src))
    if sys.argv[1] == "--fake":
        _run_fake(sys.argv[2])
    elif sys.argv[1] == "--cuda-ep":
        mp.spawn(_run_cuda_ep, args=(sys.argv[2],), nprocs=2, join=True)
    else:
        mp.spawn(_run, args=(sys.argv[1],), nprocs=WORLD, join=True)
