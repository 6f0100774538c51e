"""Architecture registry: `--arch <id>` resolves here.

Counterpart of `repro.configs.registry`. `get_config` returns every LM
configuration of the reference, as plain data (``hetero_classes`` sizes its
device classes from all ten). The port builds every one of them
(`models.model.init_params`); a config listed in ``NOT_PORTED`` would raise
`NotImplementedError` naming the ROADMAP.md §1 item that ports it, and none
is listed. ``jamba_1_5_large_398b`` is the published config, with its 16
experts.
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
#: each (consulted by `models.model.init_params`): none since item 12
NOT_PORTED: dict[str, str] = {}

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
