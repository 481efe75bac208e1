"""Hand-written CUDA kernels for the H100, each with its plain PyTorch
version beside it: ``bitunpack`` (planar bitpack decode), ``filter_agg``
(fused predicate filter + partial aggregation) and ``block_agg`` (masked
partial aggregation); ``ops``, the public wrappers with the reference's
contract; ``ref``, the plain oracles; ``_build``, the nvcc build."""
