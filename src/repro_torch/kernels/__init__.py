"""Hand-written CUDA kernels for the H100, each with its plain PyTorch
version beside it: ``bitunpack`` (planar bitpack decode), ``filter_agg``
(fused predicate filter + partial aggregation), ``block_agg`` (masked
partial aggregation) and ``flash_fwd`` (the inference attention
forward of the prefill); ``ops``, the public wrappers with the
reference's contract; ``ref``, the plain oracles; ``_build``, the nvcc
build."""
