"""Multi-pod dry run: trace every (arch x shape) on the production mesh with
fake tensors (no allocation), and take the roofline terms from the trace.

Counterpart of `repro.launch.dryrun`, with its CLI and its record's keys:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2_9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--fsdp]

The mesh is a `DeviceMesh` (of ``cuda`` devices where the card's build
of torch is installed, else of the CPU) over a fake process group of 256
(or 512) ranks, opened in this process, as the reference forces 512
host devices at import: a process has one default group, so the dry run
runs in its own. Every parameter, optimizer moment, batch and cache leaf
is this rank's block, a fake tensor wrapped as a DTensor by
`parallel.sharding`; the step (`launch.train`'s train step, `models.model.
prefill`, `models.model.decode_step`) runs under `FakeTensorMode` with the
kernels replaced by `launch.op_cost.stand_ins`, and `launch.op_cost.OpCost`
and `MemTracker` count its per-device work and peak memory. The terms are
on the H100's constants (`launch.mesh`); ``xla_cost_analysis_flops_
uncorrected`` is kept as a key and is None (there is no compiled module).

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ShapesOnly
from repro_torch.parallel import sharding as SH

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def open_fake_group(world: int) -> None:
    """This process's default group: a fake one of ``world`` ranks, this
    process rank 0 (no communication happens; collectives return at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"the process group has {dist.get_world_size()} ranks; the mesh needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def device_type() -> str:
    """The fake tensors' device: ``cuda`` where torch is built for it (the
    kernels' routes), else ``cpu`` (their plain routes, whose stand-ins
    count the kernels' work; autograd on fake CUDA tensors needs a CUDA
    build)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def fake_mesh(shape, axes=("data", "model")):
    """A mesh of ``shape`` over the fake group (opened if need be)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    open_fake_group(n)
    return DeviceMesh(device_type(), torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def _abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device (global shapes)."""
    return M.init_params(cfg, ShapesOnly()).tree


def _place(mesh, specs, tree, dtype=None):
    """Each leaf of a meta ``tree`` as a DTensor of this rank's block: a
    fake tensor (under `FakeTensorMode`) on the mesh's device."""
    def leaf(_path, x, spec):
        spec = SH.sanitize_spec(mesh, spec, x.shape)
        local = torch.empty(SH.local_shape(mesh, spec, x.shape), dtype=dtype or x.dtype,
                            device=mesh.device_type)
        return SH.to_dtensor(mesh, spec, local, x.shape)

    return SH._map_with_path(leaf, tree, specs)


def _fsdp_specs(pspecs, params):
    """Add 'data'-axis sharding on the first free dim of >=2D weights (ZeRO-3
    flavoured storage sharding; a layer's leaves gathered when the layer
    runs, `models.model._local_lm`)."""
    def leaf(_path, arr, spec):
        dims = list(spec) + [None] * (arr.ndim - len(spec))
        if arr.ndim < 2 or max(arr.shape) < 4096:
            return spec
        if any(d == "data" or (isinstance(d, tuple) and "data" in d) for d in dims):
            return spec
        for i, d in enumerate(dims):
            if d is None and arr.shape[i] % 16 == 0:
                dims[i] = "data"
                return tuple(dims)
        return spec

    return SH._map_with_path(leaf, params, pspecs)


def _moe_2d_specs(pspecs, params, mesh):
    """Expert tensors -> experts on 'model' x d_ff on the other axes (what
    `models.moe.moe_ffn_2d` computes on; the reference names 'data' alone,
    the same axes on a single pod)."""
    ff = tuple(a for a in mesh.mesh_dim_names if a != "model")
    ff = ff[0] if len(ff) == 1 else ff

    def leaf(path, spec, arr):
        if arr.ndim == 4 and path[-1] in ("w_gate", "w_up", "w_down") and "ffn" in path:
            return (None, "model", ff, None) if path[-1] == "w_down" else (None, "model", None, ff)
        return spec

    return SH._map_with_path(lambda p, a, s: leaf(p, s, a), params, pspecs)


def _fsdp_opt(pspecs):
    """AdamW's specs: mu and nu as the (FSDP or not) parameters, step
    replicated."""
    from repro_torch.optim.optimizers import OptState

    return OptState(step=(), mu=pspecs, nu=pspecs)


def _local_bytes(tree) -> int:
    from repro_torch.core.types import tree_leaves

    return sum(x.to_local().numel() * x.element_size() if hasattr(x, "to_local") else
               x.numel() * x.element_size() for x in tree_leaves(tree))


@contextlib.contextmanager
def _untracked_propagation():
    """DTensor derives an op's output metadata by running the op on fake
    tensors of the global shapes under the current fake mode, where
    `MemTracker` and `OpCost` would count them (a whole expert stack of
    Arctic, 290 GiB, at the step's first `detach`); a real run allocates
    nothing for it. Within this context that derivation runs with the
    dispatch modes off, in a fake mode of its own."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__[name]

    def untracked(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    setattr(ShardingPropagator, name, untracked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def lower_pair(cfg: ModelConfig, shape: str, mesh, *, fsdp: bool = False,
               batch: int | None = None, seq: int | None = None):
    """Trace one (arch x shape x mesh) step on fake tensors. Returns (cost,
    memory, meta): `OpCost.as_dict()`, `roofline.memory_dict`'s keys and
    {"kind"}. ``batch``/``seq`` replace the shape's B and S (train and
    prefill)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import op_cost

    kind = SP.SHAPES[shape]["kind"]
    cfg_eff = SP.mesh_adapt(SP.effective_pattern(cfg, shape), SH.axis_size(mesh, "model"))
    meta_params = _abstract_params(cfg_eff)
    pspecs = SH.param_specs(meta_params)
    if kind == "decode" and getattr(cfg_eff, "moe_2d", False):
        pspecs = _moe_2d_specs(pspecs, meta_params, mesh)
    if fsdp:
        pspecs = _fsdp_specs(pspecs, meta_params)
    # the global shapes as meta tensors, made before the fake mode (where a
    # meta tensor would become a fake one of the global size)
    if kind == "decode":
        token, _pos, meta_cache = SP.decode_specs(cfg_eff, shape)
    else:
        meta_batch = SP.input_specs(cfg_eff, shape, batch, seq)
    counter = op_cost.OpCost()
    with FakeTensorMode(), op_cost.stand_ins(), _untracked_propagation():
        tracker = MemTracker()
        with tracker:
            params = _place(mesh, pspecs, meta_params)
            if kind == "train":
                from repro_torch.launch.train import TrainState, build_train_step
                from repro_torch.optim.optimizers import OptState

                ospecs = _fsdp_opt(pspecs)            # the moments mirror the parameters
                opt = OptState(step=torch.zeros((), dtype=torch.int32),
                               mu=_place(mesh, ospecs.mu, meta_params, torch.float32),
                               nu=_place(mesh, ospecs.nu, meta_params, torch.float32))
                data = _place(mesh, SH.batch_specs(mesh, meta_batch), meta_batch)
                args = _local_bytes((params, opt, data))
                state = TrainState(params, opt)
                step = build_train_step(cfg_eff, mesh=mesh)
                with counter:
                    state, metrics = step(state, data)
                out = alias = _local_bytes((state.params, state.opt))
            elif kind == "prefill":
                data = _place(mesh, SH.batch_specs(mesh, meta_batch), meta_batch)
                args = _local_bytes((params, data))
                with counter:
                    logits = M.prefill(params, cfg_eff, data, mesh=mesh)
                out, alias = _local_bytes(logits), 0
            else:
                cache = _place(mesh, SH.cache_specs(mesh, meta_cache), meta_cache)
                tok = _place(mesh, SH.batch_specs(mesh, {"t": token}), {"t": token})["t"]
                args = _local_bytes((params, cache, tok))
                with counter:
                    logits, cache = M.decode_step(params, cfg_eff, tok, SP.SHAPES[shape]["seq"] - 1,
                                                  cache, mesh=mesh)
                alias = _local_bytes(cache)
                out = alias + _local_bytes(logits)
        peaks = tracker.get_tracker_snapshot("peak")
    peak = max(peaks.values(), key=lambda d: d.get("Total", 0))
    return counter.as_dict(), RL.memory_dict(peak, args, out, alias), {"kind": kind}


def run_pair(arch: str, shape: str, *, multi_pod: bool = False,
             fsdp: bool = False, verbose: bool = True,
             variant: dict | None = None) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    if variant:
        cfg = cfg.scaled(**variant)
    skip = SP.shape_skip_reason(cfg, shape)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "fsdp": fsdp, "time_s": 0.0, "variant": variant or {},
    }
    if skip:
        rec["status"] = "skipped"
        rec["reason"] = skip
        return rec

    t0 = time.time()
    # >50B models cannot hold params (+optimizer when training) on the model
    # axis alone: 'data'-axis weight sharding is the baseline. With the 2-D
    # expert layout the experts are already data-sharded: no blanket FSDP.
    if cfg.param_count() > 50e9 and not getattr(cfg, "moe_2d", False):
        fsdp = True
    rec["fsdp"] = fsdp
    try:
        open_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type())
        n_chips = mesh.size()
        cost, memd, meta = lower_pair(cfg, shape, mesh, fsdp=fsdp)
        coll = {"total": cost["collective_bytes"], "counts": cost["collective_counts"]}
        rl = RL.roofline({"flops": cost["flops"], "bytes accessed": cost["hbm_bytes"]}, memd, coll)
        rl["xla_cost_analysis_flops_uncorrected"] = None
        rl["scan_ops_per_dev"] = cost["scan_ops"]
        mf = RL.model_flops(cfg, SP.SHAPES[shape], meta["kind"])
        flops_global = rl["hlo_flops_per_dev"] * n_chips
        rec.update(
            status="ok",
            kind=meta["kind"],
            chips=n_chips,
            roofline=rl,
            model_flops_global=mf,
            useful_flops_ratio=(mf / flops_global) if flops_global else None,
            fits_hbm=memd["total_hbm_bytes"] <= HBM_BYTES,
            hbm_gib=memd["total_hbm_bytes"] / 1024**3,
            collective_counts=coll["counts"],
            swa_variant=SP.uses_swa_variant(cfg, shape),
            kernel_calls=cost["kernel_calls"],
        )
        if verbose:
            print(f"  memory: {memd}")
            print(f"  cost: flops={cost['flops']:.3e} bytes={cost['hbm_bytes']:.3e} "
                  f"collective={cost['collective_bytes']:.3e}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-2000:]
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", action="append", default=[],
                    help="cfg override key=value (int/bool/float autocast)")
    ap.add_argument("--tag", default=None, help="suffix for the output JSON")
    args = ap.parse_args(argv)

    variant = {}
    for kv in args.variant:
        k, v = kv.split("=", 1)
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        variant[k] = v

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    pairs = (
        [(a, s) for a in list_archs() for s in SP.SHAPES]
        if args.all
        else [(args.arch, args.shape)]
    )
    mesh_name = "pod2x16x16" if args.multi_pod else "16x16"
    for arch, shape in pairs:
        tag = f"{arch}__{shape}__{mesh_name}" + ("__fsdp" if args.fsdp else "")
        if args.tag:
            tag += f"__{args.tag}"
        path = OUT_DIR / f"{tag}.json"
        if args.skip_existing and path.exists():
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag}")
        rec = run_pair(arch, shape, multi_pod=args.multi_pod, fsdp=args.fsdp,
                       variant=variant)
        path.write_text(json.dumps(rec, indent=1, default=str))
        status = rec["status"]
        extra = (
            f" dominant={rec['roofline']['dominant']} hbm={rec['hbm_gib']:.1f}GiB"
            if status == "ok" else f" ({rec.get('reason') or rec.get('error', '')[:120]})"
        )
        print(f"  -> {status} in {rec['time_s']}s{extra}")


if __name__ == "__main__":
    main()
