"""PyTorch and CUDA port of ``repro``: the dataset -> object-storage
mapping with storage-side scans (``core/``), the device data plane —
bitpack decode, filter + aggregate and masked aggregate as CUDA kernels
written for the H100 (``kernels/``, public wrappers ``kernels.ops``),
the device pushdown (``core.pushdown_torch``, mesh rules in
``distributed.sharding``) and the packed training-data ingest from the
store to the card (``data/``).  Importing it does no CUDA work; kernels
are built on first use."""
