"""Elastic scaling: cluster resize planning with minimal data movement.

Two layers, mirroring the paper's separation:

  * storage: adding/removing OSDs is a ClusterMap epoch bump; the
    object movement plan is ``placement.pg_delta`` and the expected
    movement fraction is ~ changed_capacity / total_capacity (HRW's
    minimal-movement property, hypothesis-tested);
  * training: changing dp_size re-slices the *same* deterministic
    (seed, step) -> rows mapping, so a resized job continues the exact
    global data order with zero re-shuffling — hosts just take different
    slices.  ``replan_loader`` returns the per-rank slices before/after
    and verifies coverage.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.placement import ClusterMap, movement_fraction, pg_delta
from repro_torch.core.store import ObjectStore


@dataclasses.dataclass(frozen=True)
class ResizePlan:
    old_osds: tuple[str, ...]
    new_osds: tuple[str, ...]
    pgs_remapped: int
    movement_fraction: float
    epoch: int


def plan_storage_resize(cluster: ClusterMap,
                        add: tuple[str, ...] = (),
                        remove: tuple[str, ...] = ()) -> tuple[ClusterMap,
                                                               ResizePlan]:
    new = cluster
    for o in add:
        new = new.add_osds([o])
    for o in remove:
        new = new.remove_osd(o)
    delta = pg_delta(cluster, new)
    plan = ResizePlan(
        old_osds=cluster.osds, new_osds=new.osds,
        pgs_remapped=len(delta),
        movement_fraction=movement_fraction(cluster, new),
        epoch=new.epoch)
    return new, plan


def apply_storage_resize(store: ObjectStore,
                         add: tuple[str, ...] = (),
                         remove: tuple[str, ...] = ()) -> dict:
    """Resize + recover: after this every object is fully replicated on
    the new map and removed OSDs hold nothing the cluster needs."""
    old = store.cluster
    new, plan = plan_storage_resize(old, add, remove)
    for o in add:
        if o not in store.osds:
            store.osds[o] = type(store.osds[next(iter(store.osds))])(o)
    store.cluster = new
    stats = store.recover(old)
    return {"plan": dataclasses.asdict(plan), **stats}


def replan_loader(n_rows: int, global_batch: int,
                  old_dp: int, new_dp: int) -> dict:
    """Check a dp resize keeps the global order intact: the union of all
    ranks' row slices for a step is the same batch before and after."""
    if global_batch % old_dp or global_batch % new_dp:
        raise ValueError("global_batch must divide both dp sizes")
    idx = np.arange(global_batch)
    old_slices = [idx[r::old_dp] for r in range(old_dp)]
    new_slices = [idx[r::new_dp] for r in range(new_dp)]
    same = (np.sort(np.concatenate(old_slices)) ==
            np.sort(np.concatenate(new_slices))).all()
    return {"coverage_preserved": bool(same),
            "old_local_batch": global_batch // old_dp,
            "new_local_batch": global_batch // new_dp}
