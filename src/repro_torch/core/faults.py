"""Fault-injection harness for the self-healing storage plane.

A :class:`FaultInjector` hangs off an :class:`~repro_torch.core.store.ObjectStore`
and gives tests/benchmarks a controlled way to produce the gray failures
the paper's "failure management" claim is about — not just fail-stop
(``store.fail_osd``) but the nastier middle ground:

* **bit rot** — :meth:`flip_bits` mutates stored bytes in place on one
  replica; the stamped digest no longer matches, so any read path that
  touches the copy quarantines it and fails over (``scrub()`` finds it
  proactively).
* **torn write** — :meth:`tear_write` drops an object's xattrs on one
  replica while leaving the blob: the write landed but its metadata
  (digest, version, extent) did not — the classic crash between the two
  mutations of a non-atomic update.
* **slow OSD** — :meth:`slow` adds per-request latency to one daemon,
  exercising the hedged-read/straggler machinery without killing it.
* **transient failures** — :meth:`transient_failures` makes the next N
  requests to one OSD raise :class:`~repro_torch.core.store.TransientOSDError`
  and then recover, exercising the client's deadline/backoff retry layer.

Injection bypasses every request hook (it mutates OSD state directly
under the OSD lock), so injecting a fault is never itself subject to
faults.  Every injected corruption is recorded in :attr:`injected` so a
harness can assert ``fabric.corruptions_detected`` == injected.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.core.store import ObjectStore, OSD, TransientOSDError


@dataclass
class _OSDFaults:
    """Mutable per-OSD fault state, consulted by ``OSD._touch``."""
    slow_extra_s: float = 0.0
    transient_left: int = 0


@dataclass
class _Injection:
    """Record of one injected corruption (for detection accounting)."""
    kind: str          # "bitflip" | "torn"
    name: str
    osd_id: str


class FaultInjector:
    """Deterministic fault source wired into one store's OSDs.

    Construct with the store; the injector attaches itself to
    ``store.faults`` and to every live OSD (and ``fail_osd``/``add_osds``
    re-attach it to replacement daemons), so its :meth:`on_request` hook
    fires at the top of every served request.
    """

    def __init__(self, store: ObjectStore):
        self.store = store
        self._lock = threading.Lock()
        self._per_osd: dict[str, _OSDFaults] = {}
        self.injected: list[_Injection] = []
        store.faults = self
        for osd in store.osds.values():
            self.attach_osd(osd)

    # ------------------------------------------------------------ wiring
    def attach_osd(self, osd: OSD) -> None:
        osd.faults = self

    def _state(self, osd_id: str) -> _OSDFaults:
        with self._lock:
            return self._per_osd.setdefault(osd_id, _OSDFaults())

    # ------------------------------------------------------------ hook
    def on_request(self, osd_id: str) -> None:
        """Called by ``OSD._touch`` at the top of every served request —
        on the serving thread, so the slow-OSD sleep stalls exactly the
        requests that hit the slow daemon."""
        st = self._state(osd_id)
        with self._lock:
            extra = st.slow_extra_s
            fail = st.transient_left > 0
            if fail:
                st.transient_left -= 1
        if extra:
            time.sleep(extra)
        if fail:
            raise TransientOSDError(
                f"{osd_id}: injected transient failure")

    # ------------------------------------------------------------ faults
    def flip_bits(self, name: str, osd_id: str | None = None,
                  n_bits: int = 1) -> str:
        """Corrupt one stored replica in place (bit rot).  Flips
        ``n_bits`` bits spread across the blob on ``osd_id`` (default:
        the first up OSD holding a copy).  Returns the OSD hit."""
        osd = self._holder(name, osd_id)
        with osd.lock:
            blob = bytearray(osd.data[name])
            for k in range(max(1, n_bits)):
                pos = (k * 2654435761) % len(blob)  # spread, deterministic
                blob[pos] ^= 1 << (k % 8)
            osd.data[name] = bytes(blob)
        self.injected.append(_Injection("bitflip", name, osd.osd_id))
        return osd.osd_id

    def tear_write(self, name: str, osd_id: str | None = None) -> str:
        """Tear one replica: the blob stays but its xattrs vanish — the
        write landed, the metadata commit did not.  Returns the OSD
        hit."""
        osd = self._holder(name, osd_id)
        with osd.lock:
            osd.xattrs.pop(name, None)
        self.injected.append(_Injection("torn", name, osd.osd_id))
        return osd.osd_id

    def slow(self, osd_id: str, extra_s: float) -> None:
        """Make every request served by ``osd_id`` take ``extra_s``
        extra seconds (0 restores normal speed)."""
        with self._lock:
            self._per_osd.setdefault(osd_id, _OSDFaults()) \
                .slow_extra_s = float(extra_s)

    def transient_failures(self, osd_id: str, n: int) -> None:
        """Arm ``osd_id`` to fail its next ``n`` requests with
        :class:`TransientOSDError`, then serve normally — the
        fail-N-then-succeed gray failure the retry layer is for."""
        with self._lock:
            self._per_osd.setdefault(osd_id, _OSDFaults()) \
                .transient_left = int(n)

    def clear(self) -> None:
        """Disarm all per-OSD latency/transient faults (injected
        corruption stays — that is damage, not a knob)."""
        with self._lock:
            self._per_osd.clear()

    def campaign(self, names: list[str], *, flips: int = 3,
                 torn: int = 1, seed: int = 0) -> list[_Injection]:
        """A churn campaign against the scrub walker: inject ``flips``
        bit-rot faults and ``torn`` torn writes across DISTINCT
        ``(object, OSD)`` targets, always on a CURRENT acting-set
        holder (so the damage is in service, not on a stray), and never
        corrupting more than ``replicas - 1`` copies of one object —
        the walker must always have a verified copy to heal from.
        Deterministic per ``seed``.  Returns the injections placed
        (also appended to :attr:`injected`); fewer than requested when
        the name list can't support the budget safely."""
        import random as _random
        rng = _random.Random(seed)
        per_name: dict[str, int] = {}
        used: set[tuple[str, str]] = set()
        placed: list[_Injection] = []
        want = [("bitflip", flips), ("torn", torn)]
        for kind, budget in want:
            k = 0
            attempts = 0
            while k < budget and attempts < 64 * max(1, budget):
                attempts += 1
                name = rng.choice(names)
                acting = self.store.cluster.locate(name)
                cap = max(1, len(acting) - 1)
                if per_name.get(name, 0) >= cap:
                    continue
                holders = []
                for o in acting:
                    osd = self.store.osds[o]
                    with osd.lock:
                        held = name in osd.data
                    if held and (name, o) not in used:
                        holders.append(o)
                if not holders:
                    continue
                osd_id = rng.choice(holders)
                if kind == "bitflip":
                    self.flip_bits(name, osd_id)
                else:
                    self.tear_write(name, osd_id)
                used.add((name, osd_id))
                per_name[name] = per_name.get(name, 0) + 1
                placed.append(self.injected[-1])
                k += 1
        return placed

    # ------------------------------------------------------------ accounting
    @property
    def corruptions_injected(self) -> int:
        return len(self.injected)

    # ------------------------------------------------------------ helpers
    def _holder(self, name: str, osd_id: str | None) -> OSD:
        if osd_id is not None:
            osd = self.store.osds[osd_id]
            with osd.lock:
                held = name in osd.data
            if not held:
                raise KeyError(f"{name} not on {osd_id}")
            return osd
        for oid in self.store.cluster.up_osds:
            osd = self.store.osds[oid]
            with osd.lock:
                held = name in osd.data
            if held:
                return osd
        raise KeyError(f"{name}: no up OSD holds a copy")
