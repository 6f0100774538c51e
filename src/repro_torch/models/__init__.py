"""The LM substrate of the port: config, layers, attention, dense and MoE
FFNs, RWKV, Mamba, model.

Counterpart of `repro.models`. Ported: the ``attn``/``attn_local`` blocks
(GQA, RoPE, sliding window, softcaps, post-norms, tied embeddings, QKV
bias; DeepSeek's MLA), the ``rwkv`` blocks (RWKV-6 time and channel mix),
the ``mamba`` blocks (the selective-state-space block of Jamba), dense and
routed MoE FFNs, the stub frontends, prefill, cached decode and the loss.
Meshes raise `NotImplementedError` (ROADMAP.md §1, item 11b).
"""
