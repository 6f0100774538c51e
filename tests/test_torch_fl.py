"""The port's FL loop and its allocation backends (`repro_torch.fl`) and the
closed FedSem loop (`SemComJob`, `launch.fedsem_e2e`), on the CPU.

Against the JAX reference, on the same numpy inputs: one `run_fl` round
from the same codec parameters, client batches, channel noise and
allocation gives the reference's parameters and loss (float32, atol 1e-6
on parameters of magnitude up to 0.5 and rtol 1e-5 on the loss: two SGD
steps through convolutions summed in other orders, then the same top-|rho|
kept set); `PlannedBackend` returns the reference's hardened X on the
bridged round scenarios.

Inside the port, exactly (the counterparts of `tests/test_fl_backend.py`
and `tests/test_fedsem_e2e.py`): the virtual-clock and the real-clock
`ServiceBackend` return `PlannedBackend`'s X, tenant refits stay with their
tenant, warm rounds never lose to cold ones, and `SemComJob` closes the
loop; `fedsem_e2e --smoke --device cpu` passes its four gates.
"""
import ast
import asyncio
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AllocatorConfig as JConfig, Allocation as JAllocation
from repro.core.pgd import PGDConfig as JPGD
from repro.fl import (
    AllocationBackend as JAllocationBackend, FLConfig as JFLConfig,
    PlannedBackend as JPlannedBackend, run_fl as jrun_fl,
    sample_round_scenarios as jsample_round_scenarios,
)
from repro.semcom import autoencoder as J
from repro_torch import bridge
from repro_torch.core import AccuracyFn, AllocatorConfig, Weights, tree_index
from repro_torch.core.accuracy import default_accuracy
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import objective
from repro_torch.fl import (
    AllocationBackend, FLConfig, PlannedBackend, SemComJob, SemComJobConfig, ServiceBackend,
    plan_allocations, run_fl, sample_round_scenarios, serve_config_for,
)
from repro_torch.fl import federated
from repro_torch.launch import fedsem_e2e
from repro_torch.semcom import autoencoder as T
from repro_torch.serve import AllocService, AsyncAllocDriver, BatchPolicy, RealClockDriver
from torch_port_util import np_, to_port_params

torch.set_num_threads(1)

ALLOC = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=60))
FL = FLConfig(n_clients=3, n_subcarriers=8, rounds=2, allocator_inner="pgd")
SERVE = serve_config_for(ALLOC, policy=BatchPolicy(max_batch=2, max_wait_s=0.01))
JOB = SemComJobConfig(
    fl=FLConfig(n_clients=3, n_subcarriers=8, rounds=2, local_steps=2),
    ae=T.AEConfig(image_size=16, hidden=4, base_latent=4),
    batch_size=4,
    eval_batch=8,
    refit_after=2,
)
D_BITS = 1e4
W = Weights.ones()
PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module")
def executables():
    """One solver cache for every service of this module (the key pins the
    allocator config, the bucket and the slots, so sharing is safe)."""
    return {}


@pytest.fixture(scope="module")
def scenarios():
    return sample_round_scenarios(3, FL, D_BITS, device="cpu")


@pytest.fixture(scope="module")
def planned(scenarios):
    b = PlannedBackend(ALLOC)
    b.open(scenarios, W)
    return b


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


class _Fixed:
    """A backend answering every round with one allocation (both packages)."""

    supports_accuracy_feedback = False

    def __init__(self, alloc):
        self.alloc = alloc

    def open(self, scenarios, weights):
        pass

    def allocate(self, rnd):
        return self.alloc

    def set_accuracy(self, acc):
        return False

    def close(self):
        pass


class JFixed(_Fixed, JAllocationBackend):
    pass


class TFixed(_Fixed, AllocationBackend):
    pass


@pytest.mark.parametrize("rho,compress", [(0.4, True), (0.8, False)])
def test_one_run_fl_round_matches_the_reference(rho, compress):
    """The reference's params, its client batches and noise draws (derived
    from its keys as its `run_fl` derives them; uniform images, since only
    the training is under test) and one allocation handed to both
    packages: the same aggregated params and round loss."""
    n, steps = 2, 2
    jcfg_ae = J.AEConfig(image_size=16, hidden=4, base_latent=4)
    extra = rho <= 0.5
    cfg = dict(n_clients=n, n_subcarriers=8, rounds=1, local_steps=steps, rho_in_loss=True,
               compress=compress)
    key = jax.random.PRNGKey(7)
    _, k_data, k_train = jax.random.split(jax.random.fold_in(key, 0), 3)
    batch_of = lambda k, i: jax.random.uniform(k, (4, 16, 16, 3), minval=-1.0, maxval=1.0)
    batches = [batch_of(jax.random.fold_in(k_data, i * 1000 + s), i)
               for i in range(n) for s in range(steps)]
    z_shape = (4, 16 // (4 if extra else 2), 16 // (4 if extra else 2), 4)
    noises = [jax.random.normal(ks, z_shape) for kc in jax.random.split(k_train, n)
              for ks in jax.random.split(kc, steps)]

    X = np.zeros((n, 8), np.float32)
    X[np.arange(8) % n, np.arange(8)] = 1.0
    arrays = dict(f=np.full(n, 1e9, np.float32), P=0.01 * X, X=X, rho=np.float32(rho))
    jalloc = JAllocation(*(jnp.asarray(arrays[k]) for k in ("f", "P", "X", "rho")))
    jp0 = J.init_params(jax.random.PRNGKey(0), jcfg_ae)
    jparams, jhist = jrun_fl(
        key, jp0,
        lambda p, b, k, r: J.mse_loss_rho(p, jcfg_ae, b, r, k, extra_pool=extra),
        batch_of, JFLConfig(**cfg), backend=JFixed(jalloc),
    )

    port_batches = iter(bridge.images_from_numpy(np.asarray(b), device="cpu") for b in batches)
    port_noise = iter(bridge.images_from_numpy(np.asarray(z), device="cpu") for z in noises)
    tcfg_ae = T.AEConfig(image_size=16, hidden=4, base_latent=4)
    params, hist = run_fl(
        0, bridge.ae_params_from_numpy(jax.tree.map(np.asarray, jp0), device="cpu"),
        lambda p, b, gen, r: T.mse_loss_rho(p, tcfg_ae, b, r, next(port_noise), extra_pool=extra),
        lambda gen, i: next(port_batches),
        FLConfig(**cfg), backend=TFixed(bridge.allocation_from_numpy(arrays, device="cpu")),
    )
    for name, layer in jparams.items():
        np.testing.assert_allclose(np_(params[name]["w"]).transpose(2, 3, 1, 0),
                                   np.asarray(layer["w"]), atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(np_(params[name]["b"]), np.asarray(layer["b"]),
                                   atol=PARAM_ATOL, rtol=0)
    assert hist[0].loss == pytest.approx(jhist[0].loss, rel=LOSS_RTOL)
    assert hist[0].rho == jhist[0].rho and hist[0].upload_bits == jhist[0].upload_bits


def test_planned_backend_returns_the_references_x():
    """The reference's round scenarios, bridged: the port's plan has the
    reference's hardened X and rho (float32 round-off) round for round."""
    jfl = JFLConfig(n_clients=3, n_subcarriers=8, rounds=2, allocator_inner="pgd")
    jscen = jsample_round_scenarios(jax.random.PRNGKey(3), jfl, D_BITS)
    ref = JPlannedBackend(JConfig(inner="pgd", outer_iters=2, pgd=JPGD(steps=60)))
    from repro.core import Weights as JWeights

    ref.open(jscen, JWeights.ones())
    port = PlannedBackend(ALLOC)
    port.open([to_port_params(p) for p in jscen], W)
    for rnd in range(jfl.rounds):
        a, b = ref.allocate(rnd), port.allocate(rnd)
        np.testing.assert_array_equal(np_(b.X), np.asarray(a.X))
        np.testing.assert_allclose(float(b.rho), float(a.rho), rtol=1e-3)


# ---------------------------------------------------------------------------
# the backends, inside the port (tests/test_fl_backend.py's rows)
# ---------------------------------------------------------------------------


def test_planned_backend_is_the_offline_plan(planned, monkeypatch):
    """`plan_allocations` and `PlannedBackend` are one computation on the
    same seed's scenarios: the same plan, bit for bit. (`plan_allocations`
    solves at the default depth of ``FLConfig.allocator_inner``; here its
    config is cut to the module's, as the fixture's.)"""
    monkeypatch.setattr(federated, "AllocatorConfig", lambda inner: ALLOC._replace(inner=inner))
    sys_batch, res = plan_allocations(3, FL, D_BITS, W, device="cpu")
    assert torch.equal(sys_batch.g, planned.sys_batch.g)
    for rnd in range(FL.rounds):
        a, b = tree_index(res.alloc, rnd), planned.allocate(rnd)
        assert torch.equal(a.X, b.X) and torch.equal(a.rho, b.rho)


def _assert_matches_planned(backend, scenarios, planned):
    backend.open(scenarios, W)
    for rnd in range(FL.rounds):
        a, b = planned.allocate(rnd), backend.allocate(rnd)
        assert torch.equal(a.X, b.X)
        assert abs(float(a.rho) - float(b.rho)) <= 1e-6


def test_service_backend_virtual_matches_planned(scenarios, planned, executables):
    """ServiceBackend over the virtual-clock service == PlannedBackend, the
    exact hardened X per round (each round padded into bucket and slots)."""
    service = AllocService(SERVE, executables=executables, device="cpu")
    _assert_matches_planned(ServiceBackend(service), scenarios, planned)


def test_service_backend_real_driver_matches_planned(scenarios, planned, executables):
    service = AllocService(SERVE, executables=executables, device="cpu")
    service.warmup(scenarios)
    with RealClockDriver(service) as driver:
        _assert_matches_planned(ServiceBackend(driver), scenarios, planned)


def test_service_backend_unwraps_async_facade_and_rejects_others(executables):
    service = AllocService(SERVE, executables=executables, device="cpu")
    facade = AsyncAllocDriver(service)          # not started; unwrap only
    assert ServiceBackend(facade)._driver is facade.driver
    facade.driver.close()
    with pytest.raises(TypeError):
        ServiceBackend(object())


def test_accuracy_feedback_contract(executables):
    """PlannedBackend declines a refit; ServiceBackend takes it, and the
    service's default A(rho) is the fit."""
    fit = AccuracyFn(torch.tensor(0.5), torch.tensor(0.3))
    planned = PlannedBackend(ALLOC)
    assert planned.supports_accuracy_feedback is False and planned.set_accuracy(fit) is False
    service = AllocService(SERVE, executables=executables, device="cpu")
    backend = ServiceBackend(service)
    assert backend.supports_accuracy_feedback is True and backend.set_accuracy(fit) is True
    assert service._acc is fit


def test_tenant_refit_does_not_touch_cotenant_rounds(scenarios, planned, executables):
    """Job B pushing a steep refit between job A's rounds changes none of
    A's rounds, bit for bit, and A's rounds stay the planned ones."""
    service = AllocService(SERVE, executables=executables, device="cpu")
    a = ServiceBackend(service, tenant="job-a")
    b = ServiceBackend(service, tenant="job-b")
    a.open(scenarios, W)
    b.open(scenarios, W)
    for rnd in range(FL.rounds):
        before = a.allocate(rnd)
        assert b.set_accuracy(AccuracyFn(torch.tensor(0.2), torch.tensor(0.9)))
        after = a.allocate(rnd)
        assert torch.equal(before.X, after.X) and torch.equal(before.rho, after.rho)
        assert torch.equal(after.X, planned.allocate(rnd).X)
        assert set(torch.unique(b.allocate(rnd).X).tolist()) <= {0.0, 1.0}


def test_global_set_accuracy_still_reaches_unregistered_tenants(executables):
    service = AllocService(SERVE, executables=executables, device="cpu")
    fit = AccuracyFn(torch.tensor(0.5), torch.tensor(0.3))
    service.set_accuracy(fit)
    assert service._resolve_accuracy() is fit
    assert service._resolve_accuracy(tenant="never-registered") is fit
    own = AccuracyFn(torch.tensor(0.7), torch.tensor(0.2))
    service.set_accuracy(own, tenant="job-x")
    assert service._resolve_accuracy(tenant="job-x") is own
    assert service._resolve_accuracy(tenant="job-y") is fit
    explicit = AccuracyFn(torch.tensor(0.9), torch.tensor(0.1))
    assert service._resolve_accuracy(explicit, tenant="job-x") is explicit


def _toy_loss(p, batch, gen):
    return torch.mean(torch.square(p["w"] - batch))


def _toy_batch(gen, i):
    return torch.randn(4, generator=gen)


def test_run_fl_backend_agnostic_and_hooked(executables):
    """The planned path and a ServiceBackend train alike (routing changes
    scheduling, never training), and the round hook sees every round."""
    seen = []

    def go(backend, hook=None):
        return run_fl(5, {"w": torch.zeros(4)}, _toy_loss, _toy_batch, FL, backend=backend,
                      round_hook=hook)

    p_planned, h_planned = go(PlannedBackend(ALLOC),
                              lambda rnd, params, alloc, stats: seen.append((rnd, float(alloc.rho))))
    p_served, h_served = go(ServiceBackend(AllocService(SERVE, executables=executables, device="cpu")))
    assert [s[0] for s in seen] == [0, 1] and all(0 < s[1] <= 1.0 for s in seen)
    for hp, hs in zip(h_planned, h_served):
        assert hp.rho == pytest.approx(hs.rho, abs=1e-6)
        assert hp.loss == pytest.approx(hs.loss, abs=1e-6)
        assert hp.energy == pytest.approx(hs.energy, rel=0.05)
    np.testing.assert_allclose(np_(p_planned["w"]), np_(p_served["w"]), atol=1e-6)


def test_service_backend_warm_rounds_dominates(scenarios, executables):
    """Each round rides the previous round's solution: its objective never
    loses to the same service's cold answer, and round 0 (no predecessor)
    is the cold round 0 bit for bit."""
    cold = ServiceBackend(AllocService(SERVE, executables=executables, device="cpu"))
    warm = ServiceBackend(AllocService(SERVE, executables=executables, device="cpu"),
                          warm_rounds=True)
    cold.open(scenarios, W)
    warm.open(scenarios, W)
    acc = default_accuracy()
    for rnd in range(FL.rounds):
        w_alloc, c_alloc = warm.allocate(rnd), cold.allocate(rnd)
        if rnd == 0:
            assert torch.equal(w_alloc.X, c_alloc.X) and torch.equal(w_alloc.f, c_alloc.f)
        o_warm = float(objective(scenarios[rnd], W, w_alloc, acc))
        o_cold = float(objective(scenarios[rnd], W, c_alloc, acc))
        assert o_warm <= o_cold + 1e-5 * max(1.0, abs(o_cold))
        assert set(torch.unique(w_alloc.X).tolist()) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# the closed loop (tests/test_fedsem_e2e.py's rows)
# ---------------------------------------------------------------------------


def test_semcom_job_closes_the_loop(executables):
    """The codec trained by `run_fl` under served allocations: rho drives the
    codec, measurements accumulate, and the refit lands in the service."""
    service = AllocService(SERVE, executables=executables, device="cpu")
    res = SemComJob(JOB, device="cpu").run(0, ServiceBackend(service))
    assert len(res.history) == JOB.fl.rounds
    for h in res.history:
        assert np.isfinite(h.loss) and 0.0 < h.rho <= 1.0 and h.energy > 0.0 and h.t_fl > 0.0
    assert len(res.measurements) == JOB.fl.rounds * (1 + len(JOB.probe_rhos))
    assert all(0.0 <= a <= 1.0 for _, a in res.measurements)
    assert res.accuracy_fit is not None and res.refit_applied and res.refit_round is not None
    assert service._acc is res.accuracy_fit
    vals = np_(res.accuracy_fit.value(torch.linspace(0.05, 1.0, 16)))
    assert np.all(np.diff(vals) >= -1e-7)


def test_semcom_job_planned_backend_declines_feedback():
    res = SemComJob(JOB, device="cpu").run(0, PlannedBackend(ALLOC))
    assert len(res.history) == JOB.fl.rounds
    assert res.accuracy_fit is not None          # measured and fit all the same
    assert res.refit_applied is False and res.refit_round is None


def test_semcom_job_feedback_off_never_pushes(executables):
    service = AllocService(SERVE, executables=executables, device="cpu")
    default_acc = service._acc
    res = SemComJob(JOB._replace(feedback=False), device="cpu").run(0, ServiceBackend(service))
    assert res.refit_applied is False and service._acc is default_acc


def test_async_facade_matches_sync_driver(executables):
    """`AsyncAllocDriver` answers request for request as the sync driver,
    and its context manager drains the driver."""
    scen = sample_round_scenarios(9, JOB.fl, 1e4, device="cpu")
    service = AllocService(SERVE, executables=executables, device="cpu")
    service.warmup(scen)
    with RealClockDriver(service) as driver:
        sync_alloc = [driver.submit(p, W).result(timeout=120.0).alloc for p in scen]

    async def go():
        async with AsyncAllocDriver(AllocService(SERVE, executables=executables, device="cpu")) as f:
            return [(await f.submit(p, W)).alloc for p in scen], f

    async_alloc, facade = asyncio.run(go())
    assert facade.driver._closed.is_set()
    for a, b in zip(sync_alloc, async_alloc):
        assert torch.equal(a.X, b.X)


def test_async_facade_concurrent_submits(executables):
    scen = sample_round_scenarios(11, JOB.fl, 1e4, device="cpu")
    service = AllocService(SERVE, executables=executables, device="cpu")
    service.warmup(scen)

    async def go():
        async with AsyncAllocDriver(service) as facade:
            return await asyncio.gather(*(facade.submit(p) for p in scen))

    outs = asyncio.run(go())
    assert sorted(c.req_id for c in outs) == list(range(len(scen)))


def test_semcom_job_is_a_function_of_its_seed():
    """Two runs of one seed train alike bit for bit (no global RNG), and
    another seed trains otherwise."""
    job = SemComJob(JOB._replace(fl=JOB.fl._replace(rounds=1)), device="cpu")
    a, b = job.run(4, PlannedBackend(ALLOC)), job.run(4, PlannedBackend(ALLOC))
    assert a.history == b.history and a.measurements == b.measurements
    assert job.run(5, PlannedBackend(ALLOC)).history != a.history


def test_fedsem_e2e_smoke_passes_its_gates(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["fedsem_e2e", "--smoke", "--device", "cpu"])
    assert fedsem_e2e.main() == 0
    out = capsys.readouterr().out
    for phase in ("[1/4]", "[2/4]", "[3/4]", "[4/4]"):
        assert phase in out


NEW_MODULES = (
    "core/distribute.py", "core/bits.py", "core/accuracy.py", "configs/fedsem_autoencoder.py",
    "semcom/__init__.py", "semcom/autoencoder.py", "data/__init__.py", "data/synthetic.py",
    "optim/__init__.py", "optim/optimizers.py", "fl/__init__.py", "fl/alloc_backend.py",
    "fl/federated.py", "fl/semcom_job.py", "launch/fedsem_e2e.py",
)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_the_reference(module):
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / module
    for node in ast.walk(ast.parse(src.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (module, name)


# ---------------------------------------------------------------------------
# federated LM fine-tuning (examples/federated_lm.py's computation)
# ---------------------------------------------------------------------------


def test_topk_sparsify_keeps_the_references_set_on_a_leaf_over_2_24():
    """A leaf of 2^24 + 1 entries (`torch.quantile` refuses more than 2^24;
    a full-width LM's embedding has 311 M): the reference's kept set, with
    the reference's float32 rank arithmetic (n itself rounds to 2^24)."""
    from repro.fl.federated import topk_sparsify as jtopk

    u = np.random.default_rng(8).standard_normal(2**24 + 1).astype(np.float32)
    got = federated.topk_sparsify({"w": torch.from_numpy(u)}, 0.3)["w"].numpy()
    want = np.asarray(jtopk({"w": jnp.asarray(u)}, 0.3)["w"])
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) == np.count_nonzero(want) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.3, 0.75, 1.0])
def test_topk_sparsify_keeps_the_references_set_with_ties(dtype, frac):
    """Leaves with ties at and around the threshold (half the entries 0, the
    rest from a few magnitudes), float32 and bfloat16: the reference's kept
    set and values, at rho below 1 and at 1."""
    from repro.fl.federated import topk_sparsify as jtopk

    rng = np.random.default_rng(11)
    u = np.where(rng.random(4099) < 0.5, 0.0, rng.choice([-3.0, -1.0, 0.5, 1.0, 2.0], 4099))
    u = u.astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = federated.topk_sparsify({"w": torch.from_numpy(u).to(tdt)}, frac)["w"].float().numpy()
    want = np.asarray(jtopk({"w": jnp.asarray(u, jdt)}, frac)["w"].astype(jnp.float32))
    np.testing.assert_array_equal(got, want)


def test_one_run_fl_round_of_a_smoke_lm_matches_the_reference():
    """The smoke Qwen2.5-3B (float32), bridged; client token batches drawn
    from the reference's keys as its `run_fl` derives them; one allocation
    with rho 0.4 handed to both: the same round loss and aggregated
    parameters (the kept sets of the sparsified uploads agree)."""
    from repro.configs.registry import get_config as jget_config
    from repro.models import model as JM
    from repro.models.config import smoke_variant as jsmoke
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.models.config import smoke_variant

    jcfg, cfg = jsmoke(jget_config("qwen2_5_3b")), smoke_variant(registry.get_config("qwen2_5_3b"))
    n, steps, rho = 2, 2, 0.4
    fl = dict(n_clients=n, n_subcarriers=8, rounds=1, local_steps=steps, lr=0.02, compress=True)
    key = jax.random.PRNGKey(7)
    _, k_data, _ = jax.random.split(jax.random.fold_in(key, 0), 3)

    def batch_of(k, i):
        toks = jax.random.randint(k, (2, 17), 0, jcfg.vocab)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    batches = [batch_of(jax.random.fold_in(k_data, i * 1000 + s), i)
               for i in range(n) for s in range(steps)]
    X = np.zeros((n, 8), np.float32)
    X[np.arange(8) % n, np.arange(8)] = 1.0
    arrays = dict(f=np.full(n, 1e9, np.float32), P=0.01 * X, X=X, rho=np.float32(rho))
    jalloc = JAllocation(*(jnp.asarray(arrays[k]) for k in ("f", "P", "X", "rho")))
    jp0 = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jparams, jhist = jrun_fl(key, jp0, lambda p, b, k: JM.loss_fn(p, jcfg, b), batch_of,
                             JFLConfig(**fl), backend=JFixed(jalloc))

    port_batches = iter({k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches)
    params, hist = run_fl(
        0, bridge.lm_tree_from_numpy(jax.tree.map(np.asarray, jp0), cfg, device="cpu"),
        lambda p, b, gen: M.loss_fn(p, cfg, b), lambda gen, i: next(port_batches),
        FLConfig(**fl), backend=TFixed(bridge.allocation_from_numpy(arrays, device="cpu")),
    )
    assert hist[0].loss == pytest.approx(jhist[0].loss, rel=LOSS_RTOL)
    got = jax.tree_util.tree_flatten_with_path(bridge.lm_params_to_numpy(params))[0]
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    for (path, a), (_, b) in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=jax.tree_util.keystr(path))


def test_federated_lm_cli_lowers_the_loss(capsys):
    from repro_torch.launch import federated_lm

    assert federated_lm.main(["--device", "cpu", "--rounds", "2"]) == 0
    assert "FL reduced loss" in capsys.readouterr().out
