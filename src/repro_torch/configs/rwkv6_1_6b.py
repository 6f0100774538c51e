"""RWKV6 "Finch" 1.6B [arXiv:2404.05892].

24L, d_model 2048 (attention-free), channel-mix d_ff 7168, vocab 65536.
Data-dependent decay is the RWKV6 contribution (kept); see DESIGN.md for
the token-shift simplification.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,              # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
)
