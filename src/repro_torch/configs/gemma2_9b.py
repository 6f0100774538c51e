"""Gemma-2 9B [arXiv:2408.00118].

42L, d_model 3584, 16 heads (GQA kv=8), d_ff 14336, vocab 256000;
local(4096)/global alternation, attn softcap 50, final softcap 30,
GeGLU, pre+post block norms, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab=256000,
    ffn_kind="geglu",
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    tie_embeddings=True,
)
