"""PRG, ibDCF keys, and the CUDA kernels with their plain versions."""
