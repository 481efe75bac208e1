"""CRUSH-like object placement: placement groups + rendezvous hashing.

Ceph's CRUSH maps object -> PG -> ordered OSD set deterministically from a
compact cluster map, so any client can locate any object with no central
lookup, and OSD failure / cluster resize moves a *minimal* set of PGs.

We reproduce those properties with highest-random-weight (HRW/rendezvous)
hashing: each (pg, osd) pair gets a stable pseudo-random score scaled by
the OSD weight; a PG's replica set is the top-R scoring *up* OSDs.  The
key minimal-movement property (verified by hypothesis tests):

  * removing/failing an OSD only remaps PGs that had that OSD in their
    replica set;
  * adding an OSD only pulls in PGs for which the new OSD now scores in
    the top R.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Iterable, Mapping

_U64 = float(1 << 64)


def _h64(*parts: object) -> int:
    h = hashlib.blake2b("\x00".join(map(str, parts)).encode(),
                        digest_size=8)
    return struct.unpack("<Q", h.digest())[0]


@dataclasses.dataclass(frozen=True)
class ClusterMap:
    """Immutable cluster description; every mutation bumps ``epoch``."""

    osds: tuple[str, ...]
    n_pgs: int = 64
    replicas: int = 3
    epoch: int = 0
    weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    down: frozenset[str] = frozenset()

    def __post_init__(self):
        if len(set(self.osds)) != len(self.osds):
            raise ValueError("duplicate osd ids")
        if self.n_pgs <= 0 or self.replicas <= 0:
            raise ValueError("n_pgs and replicas must be positive")

    # ------------------------------------------------------------ state
    @property
    def up_osds(self) -> tuple[str, ...]:
        return tuple(o for o in self.osds if o not in self.down)

    def weight(self, osd: str) -> float:
        return float(self.weights.get(osd, 1.0))

    # ------------------------------------------------------------ mapping
    def pg_of(self, obj_name: str) -> int:
        return _h64("pg", obj_name) % self.n_pgs

    def acting_set(self, pg: int, *, n: int | None = None) -> tuple[str, ...]:
        """Ordered replica set (primary first) for a placement group."""
        n = self.replicas if n is None else n
        # weighted rendezvous: score = hash^(1/w); higher wins
        cand = [(
            (_h64("hrw", pg, o) / _U64) ** (1.0 / max(self.weight(o), 1e-9)),
            o) for o in self.up_osds]
        cand.sort(reverse=True)
        return tuple(o for _, o in cand[:n])

    def locate(self, obj_name: str) -> tuple[str, ...]:
        """object -> ordered OSD replica set (primary first)."""
        return self.acting_set(self.pg_of(obj_name))

    def primary(self, obj_name: str) -> str:
        s = self.locate(obj_name)
        if not s:
            raise RuntimeError("no up OSDs")
        return s[0]

    # ------------------------------------------------------------ mutation
    def mark_down(self, osd: str) -> "ClusterMap":
        if osd not in self.osds:
            raise KeyError(osd)
        return dataclasses.replace(self, down=self.down | {osd},
                                   epoch=self.epoch + 1)

    def mark_up(self, osd: str) -> "ClusterMap":
        return dataclasses.replace(self, down=self.down - {osd},
                                   epoch=self.epoch + 1)

    def add_osds(self, new: Iterable[str]) -> "ClusterMap":
        return dataclasses.replace(self, osds=self.osds + tuple(new),
                                   epoch=self.epoch + 1)

    def remove_osd(self, osd: str) -> "ClusterMap":
        return dataclasses.replace(
            self, osds=tuple(o for o in self.osds if o != osd),
            down=self.down - {osd}, epoch=self.epoch + 1)

    def reweight(self, osd: str, w: float) -> "ClusterMap":
        return dataclasses.replace(self, weights={**self.weights, osd: w},
                                   epoch=self.epoch + 1)


def pg_delta(old: ClusterMap, new: ClusterMap) -> dict[int, tuple]:
    """PGs whose acting set changed: pg -> (old_set, new_set).

    This is the rebalance plan between two epochs; ``core.store`` uses it
    for recovery and ``distributed.elastic`` for scale-up/down planning.
    """
    if old.n_pgs != new.n_pgs:
        raise ValueError("pg count change requires a full remap")
    out = {}
    for pg in range(old.n_pgs):
        a, b = old.acting_set(pg), new.acting_set(pg)
        if a != b:
            out[pg] = (a, b)
    return out


def movement_fraction(old: ClusterMap, new: ClusterMap) -> float:
    """Fraction of (pg, replica) assignments that moved — the metric the
    minimal-movement property bounds."""
    moved = total = 0
    for pg in range(old.n_pgs):
        a, b = set(old.acting_set(pg)), set(new.acting_set(pg))
        total += max(len(a), 1)
        moved += len(b - a)
    return moved / max(total, 1)
