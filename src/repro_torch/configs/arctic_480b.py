"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56 heads (GQA kv=8), dense d_ff 4864, vocab 32000;
MoE: 128 experts top-2 with a dense FFN residual in parallel (Arctic's
"dense-MoE hybrid": every layer = dense residual MLP + 128e top-2 MoE).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    rope_theta=1e6,
    block_pattern=("attn",),
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,
)
