"""Hand-written CUDA kernels for the H100, each with its plain PyTorch
version beside it (``bitunpack``), and the plain oracles (``ref``)."""
