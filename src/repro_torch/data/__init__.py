"""Object-store-backed training data pipeline (the paper's infrastructure
applied to the LM input path), the counterpart of ``repro.data``:

  corpus        synthetic token corpus written through GlobalVOL
  pipeline      ObjectDataLoader: deterministic, rank-sliced, prefetching,
                windowed and hedged batch fetch, plain or packed
  fused_ingest  packed words -> card (device_stream) -> bitunpack kernel
                + labels (fused_batch)
"""
