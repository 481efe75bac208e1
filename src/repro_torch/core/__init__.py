"""The paper's contribution, ported to PyTorch and CUDA: dataset ->
object-storage mapping with storage-side computation, the bitpack
decode running on the card.

Layering (bottom up), each module the counterpart of ``repro.core``'s:
  placement  — CRUSH-like PG/HRW placement from a compact cluster map
  store      — RADOS-like replicated object store + objclass execution,
               digest scrub/heal and the deadline/backoff request layer
  faults     — fault-injection harness (bit rot, torn writes, slow or
               transiently failing OSDs) for the self-healing plane
  format     — physical block format, codecs, layout transformation;
               bitpack columns decode through kernels/bitunpack
  logical    — access-library-facing datasets (rows, columns, units)
  partition  — logical units -> objects (grouping/splitting/sizing)
  expr       — predicate-expression algebra: one tree for evaluation,
               zone-map interval pruning, and the wire form
  objclass   — storage-side op registry (select/project/filter/agg/...)
  scan       — the ONE query surface: Scan builder -> PhysicalPlan ->
               ScanEngine (prune pushdown, per-OSD combine/concat)
  cache      — byte-bounded LRU result cache (one per OSD, version-keyed)
  maintenance — background daemons: continuous scrub walker, small-
               object compaction, live rebalance, versioned GC
  session    — ScanSession: many-client admission front-end
               (single-flight dedup + projection coalescing)
  vol        — GlobalVOL (client plugin) / LocalVOL (storage plugin)
  skyhook    — driver/worker scheduling over the scan engine
  pushdown_torch — the device data plane: filter + aggregate where a
               shard lives, partials combined over the mesh
"""

from repro_torch.core.expr import (  # noqa: F401
    And, Between, Cmp, Const, In, Not, Or, StrPrefix, normalize)
from repro_torch.core.logical import (  # noqa: F401
    Column, Dataspace, Hyperslab, LogicalDataset, RowRange)
from repro_torch.core.partition import (  # noqa: F401
    ArrayObjectMap, ObjectMap, PartitionPolicy, load_objmap,
    plan_array_partition, plan_partition)
from repro_torch.core.placement import ClusterMap  # noqa: F401
from repro_torch.core.store import (  # noqa: F401
    CorruptObject, DataLossError, ObjectStore, PartialWriteError,
    RetryPolicy, TokenBucket, TransientOSDError, make_store)
from repro_torch.core.faults import FaultInjector  # noqa: F401
from repro_torch.core.maintenance import MaintenancePlane  # noqa: F401
from repro_torch.core.cache import ResultCache  # noqa: F401
from repro_torch.core.scan import PhysicalPlan, Scan, ScanEngine  # noqa: F401
from repro_torch.core.session import ScanSession  # noqa: F401
from repro_torch.core.vol import ArrayView, GlobalVOL, LocalVOL  # noqa: F401
from repro_torch.core.skyhook import Query, SkyhookDriver  # noqa: F401
