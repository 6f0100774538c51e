"""The LM substrate of the port: config, layers, attention, dense FFN, model.

Counterpart of `repro.models`. Ported: the dense ``attn``/``attn_local``
blocks with a dense FFN (GQA, RoPE, sliding window, softcaps, post-norms,
tied embeddings, QKV bias), prefill and cached decode. MoE, MLA, the
``mamba`` and ``rwkv`` blocks, meshes and the frontends raise
`NotImplementedError` (ROADMAP.md §1).
"""
