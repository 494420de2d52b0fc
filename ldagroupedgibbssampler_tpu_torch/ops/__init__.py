"""Device math: Gamma/Dirichlet draws (`random`) and the two CUDA kernels
of the GGS path with their plain PyTorch versions (`cuda_counts`,
`cuda_zdraw`)."""
