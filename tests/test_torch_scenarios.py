"""The port's scenario families (`repro_torch.scenarios`) against the JAX
reference's, on the CPU.

JAX's threefry streams cannot be reproduced in torch, so the families are
held to the reference's laws and invariants, not to its draws:

* the registry's mechanics, as `tests/test_scenarios.py` checks them;
* finite, positive draws and the `ShapeBucket` padding invariants;
* `build_classes` exactly the reference's (it sorts all ten architectures
  by ``active_param_count()``, so the configs must count alike);
* the law test: for each family, two-sample Kolmogorov-Smirnov tests of
  the port's draws against the reference's, 2000 devices from fixed seeds
  on each side, on three statistics (the large-scale gain, the fading and
  the cycle count), each at p > 1e-3;
* Alg. A2 feasible and no worse than every baseline on each family's draws.
"""
import jax
import numpy as np
import pytest
import torch
from scipy import stats

from repro.scenarios import build_classes as jbuild_classes, get_family as jget_family
from repro.scenarios import list_families as jlist_families
from repro_torch.core import AllocatorConfig, Weights, sample_params, solve_batch
from repro_torch.core import baselines as B
from repro_torch.core.channel import sample_request_stream
from repro_torch.core.pgd import PGDConfig
from repro_torch.core.system import feasible, report
from repro_torch.core.types import bucket_for, pad_params
from repro_torch.scenarios import (
    DEFAULT_STREAM_BBAR,
    ScenarioFamily,
    build_classes,
    get_family,
    list_families,
    register,
)
from repro_torch.scenarios.ris_geometry import large_scale_gain
from torch_port_util import np_

torch.set_num_threads(1)
FAMILIES = list_families()
#: the reference's reduced-iteration config for many small solves
#: (tests/test_scenarios.py:PGD_CFG)
PGD_CFG = AllocatorConfig(inner="pgd", outer_iters=2, pgd=PGDConfig(steps=80))
#: the law test: draws of (LAW_BATCH, LAW_N) devices per side, and the
#: least p-value each KS test must reach
LAW_BATCH, LAW_N, LAW_K, LAW_P = 200, 10, 64, 1e-3


# ---------------------------------------------------------------------------
# registry mechanics
# ---------------------------------------------------------------------------


def test_four_families_registered_as_in_the_reference():
    assert FAMILIES == tuple(jlist_families())
    assert set(FAMILIES) == {"iid_rayleigh", "ris_geometry", "gauss_markov", "hetero_classes"}


def test_get_family_unknown_name():
    with pytest.raises(ValueError, match="unknown scenario family"):
        get_family("nope")


def test_register_rejects_duplicates_and_unnamed():
    class Dup(ScenarioFamily):
        name = "iid_rayleigh"

    with pytest.raises(ValueError, match="already registered"):
        register(Dup())
    with pytest.raises(ValueError, match="no name"):
        register(ScenarioFamily())


def test_channel_shims_are_the_registry_family():
    a = sample_params(3, N=4, K=12, device="cpu")
    b = get_family("iid_rayleigh").sample(3, N=4, K=12, device="cpu")
    for k in ("g", "c", "p_max", "f_max", "dev_mask", "sc_mask"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("name", FAMILIES)
def test_stream_raises_naming_the_serving_item(name):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 8"):
        get_family(name).stream(0, 4)


def test_request_stream_shim_raises_naming_the_serving_item():
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 8"):
        sample_request_stream(0, 4)


# ---------------------------------------------------------------------------
# per-family invariants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_sample_finite_positive_and_padding_invariants(name):
    p = get_family(name).sample(5, N=3, K=8, B=DEFAULT_STREAM_BBAR * 8, device="cpu")
    for k in ("g", "c", "d", "D", "C", "p_max", "f_max", "t_sc_max"):
        a = np_(getattr(p, k))
        assert a.dtype == np.float32 and np.isfinite(a).all() and (a > 0).all(), (name, k)
    assert p.g.shape == (3, 8) and np_(p.dev_mask).sum() == 3 and np_(p.sc_mask).sum() == 8

    bucket = bucket_for(p.N, p.K)
    pp = pad_params(p, bucket.N, bucket.K)
    assert pp.B / pp.K == pytest.approx(p.B / p.K, rel=1e-6)
    assert np_(pp.dev_mask).sum() == 3 and np_(pp.sc_mask).sum() == 8
    g = np_(pp.g)
    assert np.isfinite(g).all() and (g[3:, :] == 0).all() and (g[:, 8:] == 0).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_sample_batch_shapes_and_seeding(name):
    fam = get_family(name)
    pb = fam.sample_batch(11, 3, N=4, K=12, device="cpu")
    assert pb.g.shape == (3, 4, 12) and pb.c.shape == pb.p_max.shape == (3, 4)
    again = fam.sample_batch(torch.Generator().manual_seed(11), 3, N=4, K=12, device="cpu")
    assert torch.equal(pb.g, again.g) and torch.equal(pb.c, again.c)
    assert not torch.equal(pb.g[0], pb.g[1])
    with pytest.raises(ValueError, match="batch"):
        fam.sample_batch(0, 0, device="cpu")


def test_build_classes_equal_the_references():
    for n in (1, 2, 3):
        got, want = build_classes(n), jbuild_classes(n)
        assert got == want
        assert [c.p_max_w for c in got] == [c.p_max_w for c in want]
    with pytest.raises(ValueError, match="n_classes"):
        build_classes(0)


def test_hetero_classes_draws_every_tier():
    classes = build_classes()
    assert classes[0].c_cycles == pytest.approx(1e4)
    p = get_family("hetero_classes").sample(12, N=64, K=64, device="cpu")
    f_max, p_max, c = np_(p.f_max), np_(p.p_max), np_(p.c)
    tiers = [(np.float32(cl.f_max_hz), np.float32(cl.p_max_w), cl.c_cycles) for cl in classes]
    drawn = set()
    for f, pw, cc in zip(f_max, p_max, c):
        i = [t[0] for t in tiers].index(f)            # one of the tiers, exactly
        assert pw == tiers[i][1]
        assert 0.9 * tiers[i][2] * (1 - 1e-6) <= cc <= 1.1 * tiers[i][2] * (1 + 1e-6)
        drawn.add(i)
    assert drawn == {0, 1, 2}


def test_ris_geometry_float32_holds_at_the_discs_edge():
    """The cascade neither underflows nor overflows in float32: the gain at
    the disc's edge (100 m, on either side) and at its centre equals the
    float64 geometry to float32 rounding."""
    r = torch.tensor([100.0, 100.0, 70.0, 1e-1], dtype=torch.float32)
    theta = torch.tensor([0.0, 0.5, 0.25, 0.0], dtype=torch.float32)
    got = np_(large_scale_gain(r, theta)).astype(np.float64)

    lam = 3e8 / 915e6
    users = np.stack([np_(r) * np.cos(2 * np.pi * np_(theta)), np_(r) * np.sin(2 * np.pi * np_(theta)),
                      np.zeros(4)], -1).astype(np.float64)
    bs, ris = np.array([-50.0, 0.0, 10.0]), np.array([0.0, 0.0, 10.0])
    g_bs, g_ris = 10 ** 0.5, 10 ** 0.5
    direct = g_bs * (lam / (4 * np.pi * np.linalg.norm(users - bs, axis=-1))) ** 3.5
    cascade = (g_bs * g_ris * (16 * (lam / 10) ** 2 / lam) ** 2
               / (4 * np.pi * 50.0 * np.linalg.norm(users - ris, axis=-1)) ** 2)
    assert np.all(cascade > 0.05 * direct)             # the cascade carries weight
    np.testing.assert_allclose(got, direct + cascade, rtol=1e-5)


# ---------------------------------------------------------------------------
# the law test
# ---------------------------------------------------------------------------


def _law_statistics(g, c):
    """Per device: log10 of the mean gain over subcarriers (the large-scale
    gain, up to the mean of LAW_K fadings), log10 of the ratio of two
    subcarriers' gains (the fading alone) and the cycle count."""
    g = np.asarray(g, np.float64).reshape(-1, LAW_K)
    return dict(large_scale=np.log10(g.mean(-1)), fading=np.log10(g[:, 0] / g[:, 1]),
                c=np.asarray(c, np.float64).reshape(-1))


@pytest.mark.parametrize("name", FAMILIES)
def test_family_draws_the_references_law(name):
    want = jget_family(name).sample_batch(jax.random.PRNGKey(17), LAW_BATCH, N=LAW_N, K=LAW_K)
    got = get_family(name).sample_batch(17, LAW_BATCH, N=LAW_N, K=LAW_K, device="cpu")
    w, t = _law_statistics(want.g, want.c), _law_statistics(np_(got.g), np_(got.c))
    for stat in w:
        assert len(t[stat]) == len(w[stat]) == LAW_BATCH * LAW_N
        p = stats.ks_2samp(t[stat], w[stat]).pvalue
        assert p > LAW_P, f"{name}: {stat} KS p-value {p}"
    # the population columns are the reference's, value for value
    for k in ("d", "D", "C", "t_sc_max"):
        assert set(np_(getattr(got, k)).ravel()) == set(np.asarray(getattr(want, k)).ravel()), k
    assert set(np_(got.p_max).ravel()) <= set(np.asarray(want.p_max).ravel())
    assert set(np_(got.f_max).ravel()) <= set(np.asarray(want.f_max).ravel())


# ---------------------------------------------------------------------------
# Alg. A2 against the baselines on each family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_allocator_feasible_and_beats_all_baselines_on_family(name):
    """The Fig.-4 gate on four draws of each family: Alg. A2 (PGD_CFG) is
    feasible and no worse than any of the four baselines (+1e-3)."""
    p = get_family(name).sample_batch(1, 4, N=4, K=12, device="cpu")
    w = Weights.ones()
    res = solve_batch(p, w, PGD_CFG)
    assert bool(feasible(p, res.alloc).all())
    obj = report(p, w, res.alloc)["objective"]
    assert bool(torch.isfinite(obj).all())
    for base_name, alloc in [
        ("equal", B.equal_allocation(p)),
        ("comm_only", B.comm_opt_only(p, w, 2)),
        ("comp_only", B.comp_opt_only(p, w)),
        ("random", B.random_allocation(p, 3)),
    ]:
        base = report(p, w, alloc)["objective"]
        assert bool((obj <= base + 1e-3).all()), f"{name}: proposed {obj} worse than {base_name} {base}"
