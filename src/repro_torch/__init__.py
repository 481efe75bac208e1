"""PyTorch and CUDA port of ``repro``: the dataset -> object-storage
mapping with storage-side scans, the bitpack decode in a CUDA kernel
written for the H100 (``kernels/``).  Importing it does no CUDA work;
kernels are built on first use."""
