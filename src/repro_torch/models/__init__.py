"""The LM substrate of the port: config, layers, attention, dense FFN, RWKV,
model.

Counterpart of `repro.models`. Ported: the dense ``attn``/``attn_local``
blocks with a dense FFN (GQA, RoPE, sliding window, softcaps, post-norms,
tied embeddings, QKV bias), the ``rwkv`` blocks (RWKV-6 time and channel
mix), prefill and cached decode. MoE, MLA, the ``mamba`` blocks, meshes and
the frontends raise `NotImplementedError` (ROADMAP.md §1).
"""
