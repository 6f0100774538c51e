"""FedSem objective grid (eq. 13): CUDA kernel, plain version, dispatch."""
