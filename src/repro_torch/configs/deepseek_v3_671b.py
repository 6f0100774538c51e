"""DeepSeek-V3 671B [arXiv:2412.19437].

61L, d_model 7168, 128 heads, d_ff 2048 (expert hidden), vocab 129280.
MLA: q_lora 1536, kv_lora 512, qk_nope 128, decoupled rope 64.
MoE: 1 shared + 256 routed top-8; first 3 layers dense (d_ff 18432).
(MTP head noted in DESIGN.md; main next-token head implemented.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense-prefix FFN width
    vocab=129280,
    block_pattern=("attn",),
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    n_dense_layers=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
)
