"""flash_roofline: the least time of the window's attention calls
(`counting.flash_bound` of each layer's call at its prompt length) over the
flash kernel's device time in the trace. None for a model not in bf16, and
where the trace holds no flash launch, or not one for each attention layer
of each request."""
from fedbench.yardstick import counting, names


def read(rec):
    if rec.kind != "prefill" or rec.trace is None or rec.model["dtype"] != "bfloat16":
        return None
    launches, secs = names.device_seconds(rec.trace["kernels"],
                                          lambda n: names.PORT_KERNELS["flash"] in n)
    m = rec.model
    kinds = [k for k in counting.layer_kinds(m) if k.startswith("attn")]
    if launches == 0 or launches != len(kinds) * len(rec.lengths):
        return None
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    bound = sum(counting.flash_bound(1, L, m["n_heads"], m["n_kv_heads"], hd,
                                     m.get("causal", True), counting.layer_window(m, k))[0]
                for L in rec.lengths for k in kinds)
    return 100.0 * bound / secs
