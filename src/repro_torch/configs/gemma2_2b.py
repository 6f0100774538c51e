"""Gemma-2 2B [arXiv:2408.00118].

26L, d_model 2304, 8 heads (GQA kv=4), d_ff 9216, vocab 256000; same
local/global + softcap recipe as 9B.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    ffn_kind="geglu",
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
)
