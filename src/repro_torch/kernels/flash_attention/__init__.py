"""Flash attention (forward): CUDA kernel, plain versions, dispatch."""
