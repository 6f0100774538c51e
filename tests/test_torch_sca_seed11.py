"""Where the port and the reference part on SCA seed 11, scenario 2.

`numpy_scenarios(11, N=4, K=12, batch=3)`, scenario 2, under the SCA test
config (2 outer iterations, `solve_p5` at 2 x 40 steps, the default 800-step
PGD for the full-payload start): the port's `solve_batch` objective is
-2.3466, the reference's -2.3355 to -2.3339 over one-ulp copies of the
input (ROADMAP.md §3). Stepping through `_solve_from` per start:

* the equal and low-power starts agree; the full-payload start decides;
* from the *same* start, every later stage (Theorem 1, `solve_p5`,
  repair, harden, `power_given_x`) agrees: the reference finishing from the
  port's start reaches the port's objective;
* the start itself, `full_payload_start` (800 PGD steps at rho = 1), is the
  first stage that parts. Its first gradient is as far from the float64
  gradient in the port as in the reference (softmax round-off, about 3e-5
  of its size), and Adam turns that round-off into different final powers
  for device 1, which select one of two fixed points of the alternation.
  The reference lands on either one by itself: with the start computed
  outside `jax.jit` (the same algorithm, rounded differently) it reaches
  the port's objective.

So both packages follow the same algorithm; the gap is the reference's own
sensitivity to rounding at this stage. These tests pin that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import Allocation as JAllocation, AllocatorConfig as JConfig, Weights as JWeights
from repro.core import allocator as JA
from repro.core.accuracy import default_accuracy as jdefault_accuracy
from repro.core.p5 import P5Config as JP5
from repro.core.system import objective as jobjective
from repro_torch.core import AllocatorConfig, Weights
from repro_torch.core import allocator as TA
from repro_torch.core.accuracy import default_accuracy
from repro_torch.core.p5 import P5Config
from repro_torch.core.types import tree_map
from torch_port_util import both_params, np_, numpy_scenarios

torch.set_num_threads(1)

# the SCA config of tests/test_torch_allocator.py (tests/test_serve_alloc.py:34)
JCFG = JConfig(inner="sca", outer_iters=2, p5=JP5(outer_iters=2, inner_iters=40))
TCFG = AllocatorConfig(inner="sca", outer_iters=2, p5=P5Config(outer_iters=2, inner_iters=40))
SCENARIO = 2
#: the objective that separates the two fixed points (-2.15 vs -2.35)
BASIN = -2.3


def _scenario():
    arrays, meta = numpy_scenarios(11, N=4, K=12, batch=3)
    jp, _ = both_params({k: v[SCENARIO] for k, v in arrays.items()}, meta)
    _, tp = both_params({k: v[SCENARIO:SCENARIO + 1] for k, v in arrays.items()}, meta)
    return jp, tp


_jstart = jax.jit(lambda p: JA.full_payload_start(p, JWeights.ones(), JCFG.pgd))
_jsolve_from = jax.jit(
    lambda p, start: JA._solve_from(p, JWeights.ones(), JCFG, jdefault_accuracy(), start)
)


def _jobjective(jp, alloc):
    return float(jobjective(jp, JWeights.ones(), alloc))


def _port_weights_acc():
    w = Weights(*(torch.ones(1) for _ in range(3)))
    return w, tree_map(lambda x: torch.as_tensor(x).reshape(1), default_accuracy("cpu"))


def _port_alloc(res):
    return JAllocation(*(jnp.asarray(np_(getattr(res.alloc, k))[0]) for k in ("f", "P", "X", "rho")))


def test_seed11_stages_after_the_full_payload_start_agree():
    jp, tp = _scenario()
    w, acc = _port_weights_acc()
    with torch.no_grad():
        start = TA.full_payload_start(tp, w, TCFG.pgd)
        port = TA._solve_from(tp, w, TCFG, acc, start)
    ref = _jsolve_from(jp, tuple(jnp.asarray(np_(x)[0]) for x in start))
    np.testing.assert_array_equal(np.asarray(ref.alloc.X), np_(port.alloc.X)[0])
    port_obj, ref_obj = _jobjective(jp, _port_alloc(port)), _jobjective(jp, ref.alloc)
    assert port_obj < BASIN and ref_obj < BASIN
    np.testing.assert_allclose(port_obj, ref_obj, rtol=1e-3)


def test_seed11_full_payload_start_is_where_they_part():
    jp, tp = _scenario()
    w, _ = _port_weights_acc()
    jitted = _jstart(jp)
    with torch.no_grad():
        port = TA.full_payload_start(tp, w, TCFG.pgd)
    np.testing.assert_array_equal(np.asarray(jitted[0]), np_(port[0])[0])   # f
    # device 1's total start power: the port's is more than 10% above the
    # jitted reference's; the rest of the start agrees far more closely
    p_ref, p_port = np.asarray(jitted[1]).sum(-1), np_(port[1])[0].sum(-1)
    assert p_port[1] > 1.1 * p_ref[1]
    # the jitted reference finishes in the other fixed point
    assert _jobjective(jp, _jsolve_from(jp, jitted).alloc) > BASIN
    # ... and the reference's own start computed outside jit reaches the port's
    eager = JA.full_payload_start(jp, JWeights.ones(), JCFG.pgd)
    assert _jobjective(jp, _jsolve_from(jp, eager).alloc) < BASIN


def test_seed11_full_payload_first_gradient_is_the_same_algorithm():
    """The first PGD step of the start: the port's gradient in float32 is as
    close to the float64 gradient as the reference's is."""
    from repro.core import pgd as JP
    from repro.core.system import device_rate as jrate
    from repro_torch.core import pgd as TP
    from repro_torch.core.system import device_rate as trate

    jp, tp = _scenario()
    payload, rmin = jp.D + jp.C, jp.C / jp.t_sc_max

    def jloss(z, w, w_tot):              # solve_p4_pgd's loss at kappa1 = 1, temp 1
        P, X = JP._decode(jp, z, w, w_tot, 1.0)
        r = jrate(jp, P, X)
        hinge = jnp.square(jnp.maximum(rmin - r, 0.0) / jnp.maximum(rmin, 1.0))
        return (jnp.sum(jnp.sum(P, -1) * payload / jnp.maximum(r, 1e-12))
                + 10.0 * jnp.sum(hinge) + 0.3 * jnp.sum(X * (1.0 - X)))

    _, P0, X0 = JA.equal_start(jp)
    x_aug = jnp.concatenate([jnp.clip(X0, 1e-3, 1.0),
                             jnp.maximum(1.0 - jnp.sum(X0, 0, keepdims=True), 1e-3)], 0)
    state = [np.asarray(x) for x in (
        jnp.log(x_aug),
        JP._logit(P0 / jnp.maximum(jp.p_max[:, None] * jnp.clip(X0, 1e-3, 1.0) ** 2, 1e-12)),
        JP._logit(jnp.sum(P0, -1) / jp.p_max * 1.2),
    )]
    g_ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*state)

    def port_grad(dtype):
        p = tree_map(lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, tp)
        pay, rm = p.D + p.C, p.C / p.t_sc_max

        def loss(z, w, w_tot):
            P, X = TP._decode(p, z, w, w_tot, 1.0)
            r = trate(p, P, X)
            hinge = torch.square(TP._maximum(rm - r, 0.0) / TP._maximum(rm, 1.0))
            return (torch.sum(torch.sum(P, -1) * pay / TP._maximum(r, 1e-12), -1)
                    + 10.0 * torch.sum(hinge, -1) + 0.3 * torch.sum(X * (1.0 - X), dim=(-2, -1)))

        return [g[0].double().numpy() for g in TP._grad(
            loss, *(torch.from_numpy(a.copy()).to(dtype)[None] for a in state))]

    g_port, g_exact = port_grad(torch.float32), port_grad(torch.float64)
    gz_scale = np.abs(g_exact[0]).max()
    ref_err = np.abs(np.asarray(g_ref[0], np.float64) - g_exact[0]).max()
    port_err = np.abs(g_port[0] - g_exact[0]).max()
    # both about 3e-5 of the gradient's size; neither is the other's better
    assert ref_err < 1e-4 * gz_scale and port_err < 1e-4 * gz_scale
    assert port_err < 3 * ref_err and ref_err < 3 * port_err
