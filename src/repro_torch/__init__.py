"""PyTorch and CUDA port of ``repro``: the dataset -> object-storage
mapping with storage-side scans (``core/``), the device data plane —
bitpack decode, filter + aggregate and masked aggregate as CUDA kernels
written for the H100 (``kernels/``, public wrappers ``kernels.ops``),
the device pushdown (``core.pushdown_torch``, mesh rules in
``distributed.sharding``), the packed training-data ingest from the
store to the card (``data/``), the store's client and maintenance
planes (``core``: Skyhook driver, scan sessions, fault injection,
maintenance daemons; ``distributed.elastic``: cluster resize), and
train state and KV-cache pages kept as store objects (``checkpoint``,
``serve.kvcache``; trees keyed by ``pytree``), the models, serving and
training, and the multi-device path (``distributed``: placements over a
``DeviceMesh``, the int8 pod hop; ``launch.mesh``).  Importing it does
no CUDA work; kernels are built on first use."""
