"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409].

Decoder (mistral-nemo backbone): 40L, d_model 5120, 32 heads (GQA kv=8),
d_ff 14336, vocab 131072. Pixtral-ViT vision encoder + projector are a STUB:
input_specs provides patch embeddings (frontend_dim 1024) scattered over the
leading positions. long_500k runs only as the sliding-window variant.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    arch_type="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    block_pattern=("attn",),
    frontend="vision",
    frontend_dim=1024,
    sliding_window=4096,
)
