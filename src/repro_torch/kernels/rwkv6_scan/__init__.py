"""The WKV6 recurrence of RWKV-6: CUDA kernel, plain version, dispatch."""
