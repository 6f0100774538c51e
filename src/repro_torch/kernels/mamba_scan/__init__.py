"""The selective scan of Mamba: CUDA kernel, plain version, dispatch."""
