"""The LM substrate of the port: config, layers, attention, dense FFN, RWKV,
Mamba, model.

Counterpart of `repro.models`. Ported: the dense ``attn``/``attn_local``
blocks with a dense FFN (GQA, RoPE, sliding window, softcaps, post-norms,
tied embeddings, QKV bias), the ``rwkv`` blocks (RWKV-6 time and channel
mix), the ``mamba`` blocks (the selective-state-space block of Jamba),
prefill and cached decode. MoE, MLA, meshes and the frontends raise
`NotImplementedError` (ROADMAP.md §1).
"""
