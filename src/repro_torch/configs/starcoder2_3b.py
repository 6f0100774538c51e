"""StarCoder2-3B [arXiv:2402.19173].

30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288, vocab 49152; RoPE,
gelu MLP with biases (starcoder2 uses standard MLP).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    ffn_kind="gelu",
    qkv_bias=True,
    rope_theta=1e5,
    block_pattern=("attn",),
    # long_500k runs only as the sliding-window variant (DESIGN.md §5)
    sliding_window=4096,
)
