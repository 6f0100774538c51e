"""The port's SemCom codec (`repro_torch.semcom`), its data, optimizers,
upload sizing, A(rho) refit and update sparsification against the JAX
reference, on the CPU.

The same numpy arrays go to both packages: the reference's codec
parameters (HWIO filters, through `bridge.ae_params_from_numpy`), images
and the reference's channel-noise draws (NHWC, through
`bridge.images_from_numpy`). Tolerances, all float32: codec outputs atol
1e-6; losses rtol 1e-5; gradients atol 1e-7 plus rtol 1e-4 (the two
convolution libraries sum in other orders; measured gaps are about 1e-7,
2e-9 and 1e-8 of gradients up to 0.1); `fit_power_law` rtol 1e-5;
optimizers rtol 1e-6. `latent_mask`, `compressed_bits_rho`, `tree_bits`
and `topk_sparsify`'s kept set are held equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit_power_law as jfit_power_law, tree_bits as jtree_bits
from repro.data.synthetic import image_batch as jimage_batch
from repro.fl.federated import topk_sparsify as jtopk
from repro.optim.optimizers import (
    adamw as jadamw, cosine_schedule as jcosine_schedule, sgd as jsgd,
)
from repro.semcom import autoencoder as J
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import fit_power_law, tree_bits
from repro_torch.data.synthetic import image_batch, image_stream
from repro_torch.fl import topk_sparsify
from repro_torch.optim.optimizers import (
    adamw, clip_by_global_norm, cosine_schedule, global_norm, sgd,
)
from repro_torch.semcom import autoencoder as T
from torch_port_util import np_

torch.set_num_threads(1)

JCFG = J.AEConfig(image_size=16, hidden=4, base_latent=4)
CFG = T.AEConfig(image_size=16, hidden=4, base_latent=4)
VALUE_ATOL, LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5, 1e-7, 1e-4


def nhwc(x):
    """A port NCHW tensor as the reference's NHWC numpy layout."""
    return np_(x).transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def codec():
    """(reference params, port params, reference images, port images)."""
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    tp = bridge.ae_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (4, 16, 16, 3)).astype(np.float32)
    return jp, tp, jnp.asarray(x), bridge.images_from_numpy(x, device="cpu")


@pytest.mark.parametrize("rho", [0.2, 0.5, 0.55, 1.0])
def test_encode_decode_match_the_reference(codec, rho):
    """The shape-baked codec on both sides of the pooling boundary, at the
    reference's params for that rho."""
    jcfg, cfg = JCFG._replace(rho=rho), CFG._replace(rho=rho)
    jp = J.init_params(jax.random.PRNGKey(2), jcfg)
    tp = bridge.ae_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _, _, x, tx = codec
    z, tz = J.encode(jp, jcfg, x), T.encode(tp, cfg, tx)
    assert tz.shape == (4, cfg.latent_channels) + (16 // (4 if cfg.extra_pool else 2),) * 2
    np.testing.assert_allclose(nhwc(tz), np.asarray(z), atol=VALUE_ATOL, rtol=0)
    np.testing.assert_allclose(nhwc(T.decode(tp, cfg, tz)), np.asarray(J.decode(jp, jcfg, z)),
                               atol=VALUE_ATOL, rtol=0)
    np.testing.assert_allclose(nhwc(T.forward(tp, cfg, tx)), np.asarray(J.forward(jp, jcfg, x)),
                               atol=VALUE_ATOL, rtol=0)


@pytest.mark.parametrize("rho", [0.3, 0.5, 0.8])
def test_forward_rho_and_loss_gradient_match_jax_grad(codec, rho):
    """`forward_rho` and `mse_loss_rho` with the reference's own noise draw,
    and the loss's gradient against `jax.grad` through the mask and the
    pooling branch, leaf for leaf."""
    jp, tp, x, tx = codec
    extra = rho <= 0.5
    key = jax.random.PRNGKey(5)
    z = J.encode_rho(jp, JCFG, x, rho, extra)
    tz = T.encode_rho(tp, CFG, tx, rho, extra)
    np.testing.assert_allclose(nhwc(tz), np.asarray(z), atol=VALUE_ATOL, rtol=0)
    keep = int(np.ceil(np.float32(rho) * CFG.base_latent))
    assert bool((tz[:, keep:] == 0).all())
    noise = bridge.images_from_numpy(np.asarray(jax.random.normal(key, z.shape)), device="cpu")
    np.testing.assert_allclose(nhwc(T.forward_rho(tp, CFG, tx, rho, noise)),
                               np.asarray(J.forward_rho(jp, JCFG, x, rho, key)),
                               atol=VALUE_ATOL, rtol=0)

    jloss, jgrad = jax.value_and_grad(
        lambda p: J.mse_loss_rho(p, JCFG, x, jnp.float32(rho), key, extra_pool=extra))(jp)
    live = {k: {kk: v.clone().requires_grad_(True) for kk, v in d.items()} for k, d in tp.items()}
    loss = T.mse_loss_rho(live, CFG, tx, torch.tensor(rho), noise, extra_pool=extra)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    for name, layer in jgrad.items():
        np.testing.assert_allclose(np_(live[name]["w"].grad).transpose(2, 3, 1, 0),
                                   np.asarray(layer["w"]), atol=GRAD_ATOL, rtol=GRAD_RTOL)
        np.testing.assert_allclose(np_(live[name]["b"].grad), np.asarray(layer["b"]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_proxy_accuracy_matches_and_a_loud_channel_hurts(codec):
    """`proxy_accuracy_rho` equals the reference's on the same noise; and
    noise 3.0 against 0.0 (a large gap only: the reference's finer ordering
    check fails on its own draw, ROADMAP.md §3) lowers it."""
    jp, tp, x, tx = codec
    key = jax.random.PRNGKey(3)
    z = J.encode_rho(jp, JCFG, x, 0.75, False)
    noise = bridge.images_from_numpy(np.asarray(jax.random.normal(key, z.shape)), device="cpu")
    for std in (0.0, 0.1, 3.0):
        got = float(T.proxy_accuracy_rho(tp, CFG._replace(noise_std=std), tx, 0.75, noise))
        want = float(J.proxy_accuracy_rho(jp, JCFG._replace(noise_std=std), x, 0.75, key))
        assert 0.0 <= got <= 1.0
        assert got == pytest.approx(want, abs=1e-5)
    clean = float(T.proxy_accuracy_rho(tp, CFG._replace(noise_std=0.0), tx, 0.75, noise))
    loud = float(T.proxy_accuracy_rho(tp, CFG._replace(noise_std=3.0), tx, 0.75, noise))
    assert loud < clean


def test_forward_rho_draws_its_noise_from_the_generator(codec):
    """A generator as ``noise`` draws the standard normal from it (same seed,
    same output) and leaves the global RNG alone."""
    _, tp, _, tx = codec
    state = torch.random.get_rng_state()
    a = T.forward_rho(tp, CFG, tx, 0.8, torch.Generator().manual_seed(7))
    b = T.forward_rho(tp, CFG, tx, 0.8, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, T.forward_rho(tp, CFG, tx, 0.8))
    assert torch.equal(state, torch.random.get_rng_state())


@pytest.mark.parametrize("rho", [1e-6, 0.1, 0.25, 0.3, 0.375, 0.5, 0.51, 0.7, 0.75, 0.9999999, 1.0])
def test_mask_and_bit_counts_equal_the_references(rho):
    for base in (4, 8):
        jcfg, cfg = JCFG._replace(base_latent=base), CFG._replace(base_latent=base)
        np.testing.assert_array_equal(np_(T.latent_mask(cfg, rho)), np.asarray(J.latent_mask(jcfg, rho)))
        np.testing.assert_array_equal(np_(T.latent_mask(cfg, torch.tensor(rho))),
                                      np.asarray(J.latent_mask(jcfg, jnp.float32(rho))))
        assert T.compressed_bits_rho(cfg, rho) == J.compressed_bits_rho(jcfg, rho)
        assert cfg._replace(rho=rho).compressed_bits == jcfg._replace(rho=rho).compressed_bits


def test_tree_bits_and_init_law_match_the_reference():
    """The codec's upload size is the reference's, and `init_params` draws
    its filters uniform in +-1/sqrt(k k cin) with zero biases."""
    jp = J.init_params(jax.random.PRNGKey(0), JCFG)
    tp = T.init_params(torch.Generator().manual_seed(0), CFG)
    assert T.param_bits(tp) == tree_bits(tp) == jtree_bits(jp) == J.param_bits(jp)
    for name, layer in tp.items():
        o, i, k, _ = layer["w"].shape
        assert (k, k, i, o) == jp[name]["w"].shape
        scale = 1.0 / np.sqrt(k * k * i)
        assert float(layer["w"].abs().max()) <= scale and float(layer["w"].abs().max()) > 0.5 * scale
        assert float(layer["b"].abs().max()) == 0.0


def test_the_autoencoder_config_is_the_references():
    from repro.configs.registry import get_config as jget_config

    assert tuple(get_config("fedsem_autoencoder")) == tuple(jget_config("fedsem_autoencoder"))


@pytest.mark.parametrize("seed", range(6))
def test_fit_power_law_matches_the_reference(seed):
    """Random measurements, the clip at both ends of b among them (seeds 4
    and 5: a decreasing and a steep curve)."""
    rng = np.random.default_rng(seed)
    rhos = rng.uniform(0.05, 1.0, 12).astype(np.float32)
    a, b = {4: (0.5, -0.5), 5: (0.3, 2.0)}.get(seed, (0.6, 0.4))
    accs = (a * rhos**b * rng.uniform(0.9, 1.1, 12)).astype(np.float32)
    accs[0] = 0.0 if seed == 3 else accs[0]        # the 1e-9 floor
    got, want = fit_power_law(rhos, accs), jfit_power_law(jnp.asarray(rhos), jnp.asarray(accs))
    np.testing.assert_allclose(float(got.a), float(want.a), rtol=1e-5)
    np.testing.assert_allclose(float(got.b), float(want.b), rtol=1e-5)
    assert 0.05 <= float(got.b) <= 0.95


def test_image_batch_law_and_determinism():
    """NCHW float32 in [-1, 1] on the generator's device; one seed, one
    batch; and the reference's law (pixel mean, spread and the share of
    clipped pixels over 256 images, against the reference's own draw)."""
    a = image_batch(torch.Generator().manual_seed(0), 256, size=16)
    assert a.shape == (256, 3, 16, 16) and a.dtype == torch.float32
    assert float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    assert torch.equal(a[:4], image_batch(torch.Generator().manual_seed(0), 256, size=16)[:4])
    assert not torch.equal(a, image_batch(torch.Generator().manual_seed(1), 256, size=16))
    stream = image_stream(torch.Generator().manual_seed(0), 256, size=16)
    assert torch.equal(next(stream), a) and not torch.equal(next(stream), a)
    ref = np.asarray(jimage_batch(jax.random.PRNGKey(0), 256, size=16))
    x = nhwc(a)
    assert abs(x.mean() - ref.mean()) < 0.05
    assert abs(x.std() - ref.std()) < 0.05
    assert abs((np.abs(x) == 1.0).mean() - (np.abs(ref) == 1.0).mean()) < 0.03


@pytest.mark.parametrize("seed", range(5))
def test_adamw_descends_quadratic(seed):
    target = torch.from_numpy(np.random.default_rng(seed).standard_normal(8).astype(np.float32))
    params = {"w": torch.zeros(8)}
    init, update = adamw(0.1)
    state = init(params)
    for _ in range(100):
        g = {"w": 2.0 * (params["w"] - target)}
        params, state = update(g, state, params)
    assert float(torch.sum(torch.square(params["w"] - target))) < 0.05


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adamw", "adamw_decay_cosine"])
def test_optimizers_match_the_reference(name):
    """Ten updates from the same numpy gradients, leaf for leaf; the
    test_substrate momentum case (0.9 - 0.19) among them."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "n": {"b": rng.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), p0)
             for _ in range(10)]
    opts = {
        "sgd": ((sgd, (0.1,), {}), (jsgd, (0.1,), {})),
        "sgd_momentum": ((sgd, (0.1,), {"momentum": 0.9}), (jsgd, (0.1,), {"momentum": 0.9})),
        "adamw": ((adamw, (3e-3,), {}), (jadamw, (3e-3,), {})),
        "adamw_decay_cosine": ((adamw, (cosine_schedule(1e-2, 3, 10),), {"weight_decay": 0.1}),
                               (jadamw, (jcosine_schedule(1e-2, 3, 10),), {"weight_decay": 0.1})),
    }[name]
    (t_opt, t_args, t_kw), (j_opt, j_args, j_kw) = opts
    (t_init, t_update), (j_init, j_update) = t_opt(*t_args, **t_kw), j_opt(*j_args, **j_kw)
    tp = jax.tree.map(torch.from_numpy, p0)
    jp = jax.tree.map(jnp.asarray, p0)
    ts, js = t_init(tp), j_init(jp)
    for g in grads:
        tp, ts = t_update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp, js = j_update(jax.tree.map(jnp.asarray, g), js, jp)
    for t, j in zip(jax.tree.leaves(jax.tree.map(np_, tp)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-6, atol=1e-7)

    # test_substrate's momentum case
    init, update = sgd(0.1, momentum=0.9)
    p, g = {"w": torch.ones(3)}, {"w": torch.ones(3)}
    s = init(p)
    p1, s = update(g, s, p)
    p2, _ = update(g, s, p1)
    np.testing.assert_allclose(np_(p2["w"]), 0.9 - 0.19, rtol=1e-6)


def test_clip_by_global_norm_and_cosine_schedule():
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), 10.0, rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(0)) == 0.0
    np.testing.assert_allclose(float(lr(10)), 1.0, rtol=1e-5)
    assert float(lr(100)) < 1e-3


@pytest.mark.parametrize("frac", [0.2, 0.05, 0.37, 0.5, 0.9, 0.999, 1.0])
def test_topk_sparsify_keeps_the_references_entries(frac):
    """Per leaf, the kept set (magnitude at or above the linearly
    interpolated (1 - frac) quantile) is the reference's, exactly; the
    reference's own case (arange(100) - 50) among the leaves."""
    rng = np.random.default_rng(int(frac * 1000))
    update = {
        "ramp": np.arange(100, dtype=np.float32) - 50.0,
        "w": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
        "b": rng.standard_normal(7).astype(np.float32),
    }
    got = topk_sparsify(jax.tree.map(torch.from_numpy, update), frac)
    want = jtopk(jax.tree.map(jnp.asarray, update), frac)
    for k in update:
        np.testing.assert_array_equal(np_(got[k]), np.asarray(want[k]))
    if frac == 0.2:
        nz = int((got["ramp"] != 0).sum())
        assert 15 <= nz <= 25 and float(got["ramp"][0]) == -50.0 and float(got["ramp"][99]) == 49.0
