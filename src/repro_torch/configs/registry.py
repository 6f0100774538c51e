"""Architecture registry: `--arch <id>` resolves here.

Counterpart of `repro.configs.registry`. `get_config` returns every LM
configuration of the reference, as plain data (``hetero_classes`` sizes its
device classes from all ten). Which of them the port can build is decided at
model construction: `models.model.init_params` raises `NotImplementedError`
naming the ROADMAP.md §1 item that ports what a config needs (MoE and MLA
layers, and the configs listed in ``NOT_PORTED``).
``jamba_1_5_large_398b`` is the published config, with its 16 experts; the
port runs its dense cut, ``CONFIG.scaled(n_experts=0, top_k=0)``.
``fedsem_autoencoder`` is the paper's own codec: its config is a
`repro_torch.semcom.AEConfig`, not an LM config.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

#: the reference's architectures (`repro.configs.registry.ARCHS`)
ARCHS = (
    "arctic_480b",
    "deepseek_v3_671b",
    "rwkv6_1_6b",
    "jamba_1_5_large_398b",
    "starcoder2_3b",
    "gemma2_9b",
    "qwen2_5_3b",
    "hubert_xlarge",
    "gemma2_2b",
    "pixtral_12b",
    "fedsem_autoencoder",   # the paper's own model (not an LM config)
)
#: configs the port does not run yet, and the ROADMAP.md §1 item that ports
#: each (consulted by `models.model.init_params`)
NOT_PORTED = {
    "arctic_480b": "item 12 (MoE and MLA)",
    "deepseek_v3_671b": "item 12 (MoE and MLA)",
}

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    """The registry key of an arch id or a config's ``name`` (``gemma2-9b``)."""
    return _ALIASES.get(name, name).replace("-", "_")


def get_config(name: str) -> ModelConfig:
    """An arch's config (``fedsem_autoencoder``: its `AEConfig`)."""
    name = canonical(name)
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def list_archs():
    return [a for a in ARCHS if a != "fedsem_autoencoder"]
