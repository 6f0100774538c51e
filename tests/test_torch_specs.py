"""The port's `launch.specs` against the reference's `repro.launch.specs`.

Every function, for all ten LM configs and all four input shapes: the skip
reasons, the sliding-window variant, `mesh_adapt`'s heads, the batch layout
of `input_specs` (the reference's ``ShapeDtypeStruct`` is a ``meta``
tensor in the port) and `decode_specs`' token, position and cache (the
reference's cache stacks each stage's layers; the port keeps one cache per
layer). Nothing is allocated on either side.
"""
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch import specs as JS
from repro_torch.configs import registry
from repro_torch.launch import specs as S

torch.set_num_threads(1)

ARCHS = registry.list_archs()
SHAPES = tuple(JS.SHAPES)
#: the configs whose cache the port does not build (MoE and MLA layers)
UNPORTED = ("arctic_480b", "deepseek_v3_671b", "jamba_1_5_large_398b")


def _fields(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def _dtype(x):
    """A ShapeDtypeStruct's or a tensor's type, by name."""
    return str(x.dtype).removeprefix("torch.")


def test_shapes_are_the_references():
    assert S.SHAPES == JS.SHAPES


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_skips_and_swa_variant_match_reference(arch, shape):
    cfg, jcfg = registry.get_config(arch), jget_config(arch)
    want = JS.shape_skip_reason(jcfg, shape)
    got = S.shape_skip_reason(cfg, shape)
    assert (got is None) == (want is None)
    if want is not None:
        assert want.startswith(got)
    assert S.uses_swa_variant(cfg, shape) == JS.uses_swa_variant(jcfg, shape)
    assert _fields(S.effective_pattern(cfg, shape)) == _fields(JS.effective_pattern(jcfg, shape))


@pytest.mark.parametrize("model_axis", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_adapt_matches_reference(arch, model_axis):
    cfg, jcfg = registry.get_config(arch), jget_config(arch)
    assert _fields(S.mesh_adapt(cfg, model_axis)) == _fields(JS.mesh_adapt(jcfg, model_axis))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    cfg, jcfg = registry.get_config(arch), jget_config(arch)
    want = JS.input_specs(jcfg, shape)
    got = S.input_specs(cfg, shape)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert _dtype(got[name]) == _dtype(spec), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_specs_match_reference(arch, shape):
    """Each layer's cache: the reference's stacked entry at its period."""
    cfg, jcfg = registry.get_config(arch), jget_config(arch)
    if arch in UNPORTED:
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1, item 12"):
            S.decode_specs(cfg, shape)
        return
    jtok, jpos, jcache = JS.decode_specs(jcfg, shape)
    tok, pos, cache = S.decode_specs(cfg, shape)
    for got, want in ((tok, jtok), (pos, jpos)):
        assert got.device.type == "meta"
        assert tuple(got.shape) == tuple(want.shape) and _dtype(got) == _dtype(want)
    eff = S.effective_pattern(cfg, shape)
    assert len(cache) == eff.n_layers
    layer = 0
    for name, n_periods, _moe in eff.stages():
        for _period in range(n_periods):
            for j in range(eff.pattern_len):
                want = jcache[name][f"b{j}"]
                got = cache[layer]
                assert sorted(got) == sorted(want), (layer, sorted(got), sorted(want))
                for key, spec in want.items():
                    assert got[key].device.type == "meta"
                    assert tuple(got[key].shape) == tuple(spec.shape[1:]), (layer, key)
                    assert _dtype(got[key]) == _dtype(spec), (layer, key)
                layer += 1
    assert layer == len(cache)


def test_specs_allocate_nothing():
    """A full-width Gemma-2 9B decode cache at decode_32k (B 128, S 32768:
    hundreds of GB if it were real) and a Pixtral train_4k batch are meta
    tensors only."""
    _tok, _pos, cache = S.decode_specs(registry.get_config("gemma2_9b"), "decode_32k")
    nbytes = sum(t.numel() * t.element_size() for c in cache for t in c.values())
    assert nbytes > 100 * 2**30
    assert all(t.device.type == "meta" for c in cache for t in c.values())
    batch = S.input_specs(registry.get_config("pixtral_12b"), "train_4k")
    assert tuple(batch["patch_embeds"].shape) == (256, 1024, 1024)
    assert all(t.device.type == "meta" for t in batch.values())


def test_input_specs_cut_to_a_run():
    """``batch`` and ``seq`` replace a shape's B and S: the layouts the
    card's runs draw (HuBERT B 4, S 1500; Pixtral B 1, S 8192: 1024
    patches, the cap; S 1000: S // 4)."""
    hubert = S.input_specs(registry.get_config("hubert_xlarge"), "prefill_32k", batch=4, seq=1500)
    assert {k: tuple(v.shape) for k, v in hubert.items()} == {
        "frame_embeds": (4, 1500, 512), "labels": (4, 1500), "mask": (4, 1500)}
    pixtral = registry.get_config("pixtral_12b")
    assert tuple(S.input_specs(pixtral, "prefill_32k", 1, 8192)["patch_embeds"].shape) == (1, 1024, 1024)
    assert tuple(S.input_specs(pixtral, "prefill_32k", 2, 1000)["patch_embeds"].shape) == (2, 250, 1024)
