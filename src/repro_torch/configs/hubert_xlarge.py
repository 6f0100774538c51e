"""HuBERT X-Large [arXiv:2106.07447].

48L encoder-only, d_model 1280, 16 heads (MHA kv=16), d_ff 5120, 504
masked-prediction classes. Conv feature extractor is a STUB: input_specs
provides precomputed frame embeddings (frontend_dim 512) -> linear proj.
No decode shapes (encoder-only; DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    n_classes=504,
    ffn_kind="gelu",
    causal=False,
    block_pattern=("attn",),
    frontend="audio",
    frontend_dim=512,
)
