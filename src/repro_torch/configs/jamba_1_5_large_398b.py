"""Jamba-1.5-Large 398B [arXiv:2403.19887 / Jamba-1.5 report].

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536.
Mamba:attention 7:1 interleave (1 attn per 8-layer period); MoE 16e top-2 on
every other layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    block_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=24576,
    ssm_state=16,
    ssm_expand=2,
)
