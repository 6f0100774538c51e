"""ModelConfig: one dataclass describing every architecture of the LM substrate.

A plain copy of `repro.models.config` (pure Python), kept here so the port
imports nothing of the reference package. The layer stack is a cycle over
`block_pattern` (e.g. gemma2 alternates ("attn_local", "attn")). The
reference scans stacked per-period parameters; the port keeps one module per
layer (`repro_torch.models.model`), and `stages()` still names the periods.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- attention options ---
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None     # window for "attn_local" blocks
    attn_softcap: Optional[float] = None     # gemma2 attention logit softcap
    final_softcap: Optional[float] = None    # gemma2 final logit softcap
    causal: bool = True                      # False => encoder (hubert)
    # --- layer pattern (cycled) ---
    block_pattern: Tuple[str, ...] = ("attn",)   # attn | attn_local | mamba | rwkv
    # --- FFN / MoE ---
    ffn_kind: str = "swiglu"                 # swiglu | gelu
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                       # MoE FFN on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    n_dense_layers: int = 0                  # deepseek: dense FFN prefix
    moe_d_ff: Optional[int] = None           # expert hidden (deepseek: 2048)
    moe_dense_residual: bool = False         # arctic: dense FFN in parallel w/ MoE
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    # --- SSM ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    # --- frontends (stub: precomputed embeddings) ---
    frontend: Optional[str] = None           # None | "audio" | "vision"
    frontend_dim: int = 512                  # stub embedding dim before proj
    n_classes: int = 0                       # hubert prediction classes
    # --- misc ---
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    post_norm: bool = False                  # gemma2 pre+post block norms
    # --- perf knobs (§Perf hillclimbing) ---
    ssm_io_bf16: bool = False  # stream mamba scan inputs (x, dt, B, C) in
                               # bf16 (state & step math stay fp32)
    scan_unroll: int = 1      # unroll factor for mamba/rwkv time scans:
                              # unrolled steps fuse, cutting per-step HBM
                              # round-trips of the recurrent state
    moe_2d: bool = False      # serving: experts on 'model' x d_ff on 'data'
                              # (tokens replicated) instead of FSDP weight
                              # gathers — decode is weight-bound, tokens tiny
    attn_q_chunk: int = 512   # jnp flash-attention tile sizes
    attn_kv_chunk: int = 1024

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_len(self) -> int:
        return len(self.block_pattern)

    def stages(self):
        """(pattern, n_periods, moe_enabled_flags) stacks; deepseek gets a
        dense prefix stage. Every stage length must be divisible by the
        pattern length."""
        out = []
        if self.n_dense_layers:
            assert self.n_dense_layers % self.pattern_len == 0
            out.append(("dense_prefix", self.n_dense_layers // self.pattern_len, False))
        rest = self.n_layers - self.n_dense_layers
        assert rest % self.pattern_len == 0, (
            f"{self.name}: {rest} layers not divisible by pattern {self.block_pattern}"
        )
        out.append(("main", rest // self.pattern_len, self.n_experts > 0))
        return out

    def is_moe_layer(self, global_idx: int) -> bool:
        if self.n_experts == 0 or global_idx < self.n_dense_layers:
            return False
        return (global_idx % self.moe_every) == self.moe_offset

    # ---------------- accounting (roofline §7) ----------------
    def param_count(self) -> float:
        """Analytic parameter count (embeddings + stacks + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        for i in range(self.n_layers):
            kind = self.block_pattern[i % self.pattern_len]
            if kind.startswith("attn"):
                if self.use_mla:
                    qlr, kvlr, rd = self.q_lora_rank, self.kv_lora_rank, self.qk_rope_dim
                    n += d * qlr + qlr * H * (hd + rd)        # q down/up
                    n += d * (kvlr + rd) + kvlr * H * 2 * hd  # kv down/up
                    n += H * hd * d                           # o
                else:
                    n += d * H * hd + 2 * d * KV * hd + H * hd * d
            elif kind == "mamba":
                di = self.ssm_expand * d
                n += 2 * d * di + di * self.ssm_conv + di * (2 * self.ssm_state + 2) + di * d
            elif kind == "rwkv":
                n += 4 * d * d + d * d  # r,k,v,g + out
                n += 2 * d * 64         # decay lora
            # ffn (every layer has one: jamba puts MoE/MLP after mamba blocks
            # too; rwkv's channel-mix is its FFN)
            if kind == "rwkv":
                n += d * ff + ff * d + d * d
            elif self.is_moe_layer(i):
                eff = self.moe_d_ff or ff
                n += self.n_experts * 3 * d * eff
                n += self.n_shared_experts * 3 * d * eff
                n += d * self.n_experts  # router
                if self.moe_dense_residual:
                    n += 3 * d * ff
            else:
                n += (3 if self.ffn_kind in ("swiglu", "geglu") else 2) * d * ff
        return float(n)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        eff = self.moe_d_ff or ff
        inactive = 0.0
        for i in range(self.n_layers):
            if self.is_moe_layer(i):
                inactive += (self.n_experts - self.top_k) * 3 * d * eff
        return self.param_count() - float(inactive)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family: <=2 periods, d<=512, <=4 experts."""
    pat = cfg.pattern_len
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, 2))
    return cfg.scaled(
        n_layers=2 * pat if cfg.n_dense_layers == 0 else 2 * pat + pat,
        n_dense_layers=pat if cfg.n_dense_layers else 0,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=d // heads,
        d_ff=min(cfg.d_ff, 512),
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else None,
        vocab=min(cfg.vocab, 512),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        q_lora_rank=min(cfg.q_lora_rank, 64) if cfg.q_lora_rank else 0,
        kv_lora_rank=min(cfg.kv_lora_rank, 32) if cfg.kv_lora_rank else 0,
        qk_rope_dim=min(cfg.qk_rope_dim, 16) if cfg.qk_rope_dim else 0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        frontend_dim=min(cfg.frontend_dim, 64),
        dtype="float32",
    )
