"""Architecture registry: `--arch <id>` resolves here.

Counterpart of `repro.configs.registry`. The port has the configurations
whose blocks it runs (``jamba_1_5_large_398b`` is the published config, with
its 16 experts: `models.model.init_params` raises on it, naming ROADMAP.md
§1 item 12, and runs its dense cut, ``CONFIG.scaled(n_experts=0,
top_k=0)``); every other architecture of the reference raises
`NotImplementedError` naming the ROADMAP.md §1 item that ports it.
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
#: architectures the port runs
PORTED = ("gemma2_2b", "qwen2_5_3b", "rwkv6_1_6b", "jamba_1_5_large_398b")
#: where each other architecture is ported (ROADMAP.md §1)
NOT_PORTED = {
    "arctic_480b": "item 12 (MoE and MLA)",
    "deepseek_v3_671b": "item 12 (MoE and MLA)",
    "starcoder2_3b": "item 11 (training and the remaining dense configs)",
    "gemma2_9b": "item 11 (training and the remaining dense configs)",
    "hubert_xlarge": "item 11 (training and the remaining dense configs; audio frontend)",
    "pixtral_12b": "item 11 (training and the remaining dense configs; vision frontend)",
    "fedsem_autoencoder": "item 10 (the FL and SemCom closed loop)",
}

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    name = _ALIASES.get(name, name).replace("-", "_")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md §1, {NOT_PORTED[name]}"
        )
    if name not in PORTED:
        raise ValueError(f"unknown architecture {name!r}; known: {', '.join(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG

