"""wkv6_roofline: the least time of the window's WKV6 calls
(`counting.wkv_bound` at the bf16 model's types: r/k/v bf16, w and y
float32) over the WKV6 kernel's device time in the trace. None for a model
not in bf16, and where the trace holds no WKV6 launch, or not one for each
RWKV layer of each request."""
from fedbench.yardstick import counting, names


def read(rec):
    if rec.kind != "prefill" or rec.trace is None or rec.model["dtype"] != "bfloat16":
        return None
    launches, secs = names.device_seconds(rec.trace["kernels"],
                                          lambda n: names.PORT_KERNELS["wkv6"] in n)
    m = rec.model
    n_rwkv = sum(k == "rwkv" for k in counting.layer_kinds(m))
    if launches == 0 or launches != n_rwkv * len(rec.lengths):
        return None
    hd = m.get("rwkv_head_dim", 64)
    bound = n_rwkv * sum(counting.wkv_bound(1, m["d_model"] // hd, L, hd, 2, 4, 4)[0]
                         for L in rec.lengths)
    return 100.0 * bound / secs
