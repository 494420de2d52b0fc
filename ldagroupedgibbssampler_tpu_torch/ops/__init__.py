"""Device math: Gamma/Dirichlet/Poisson draws (`random`), count rebuilds
(`counts`), Philox (`philox`) and the CUDA kernels with their plain PyTorch
versions: the GGS path's `cuda_counts` and `cuda_zdraw`, the PCGS family's
`cuda_pcgs`."""
