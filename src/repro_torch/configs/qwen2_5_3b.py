"""Qwen2.5-3B [hf:Qwen/Qwen2.5-3B family card].

36L, d_model 2048, 16 heads (GQA kv=2), d_ff 11008, vocab 151936; QKV bias,
swiglu, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    arch_type="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    block_pattern=("attn",),
    tie_embeddings=True,
    # long_500k runs only as the sliding-window variant (DESIGN.md §5)
    sliding_window=4096,
)
