"""The collector fleet: a directory of host pairs, placement, live
migration and failover (the port of ``fuzzyheavyhitters_tpu/protocol/fleet.py``).

The protocol runs one collection against exactly two collector servers.
Below the leader a collection survives one restarted server (replayed
verbs, plane resets, checkpoint restores), but it would still die with its
pair, and a busy pair could not shed a tenant.  This module is the layer
above the pair:

- :class:`FleetDirectory`: the pairs registered (boot ids, capacity, the
  load signals ``status`` reports: the tenant scheduler's stall-fill ratio
  and the oldest collection's progress age) and each collection's
  placement.  Servers of other processes register through files:
  ``bin/server.py`` writes ``<FHH_FLEET>/<pair>_s<id>.json`` when it serves,
  and :meth:`FleetDirectory.scan` folds the two halves into a pair.  Tests
  register pairs directly.
- :class:`FleetPlacer`: the leader's scheduler.  :meth:`~FleetPlacer.place`
  puts a new collection on the least-loaded pair;
  :meth:`~FleetPlacer.migrate` moves a live collection to another pair at a
  window boundary and :meth:`~FleetPlacer.failover` moves one off a dead
  pair from its newest checkpoint (the mechanics are
  ``leader_rpc.WindowedIngest.migrate`` / ``failover_to``; the placer
  decides where and keeps the placements true).

Load: a pair's placed collections over its capacity, then the stall-fill
ratio (the pair's card is already shared), then the progress age (some
collection is wedged), then the name.  A total order is all placement
needs.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import time

FLEET_COUNTERS = ("placement_decisions", "session_migrations", "session_failovers")


@dataclasses.dataclass
class HostPair:
    """One registered collector pair: two servers make one protocol unit."""

    name: str
    host0: str = ""
    port0: int = 0
    host1: str = ""
    port1: int = 0
    boot0: str = ""
    boot1: str = ""
    capacity: int = 4
    alive: bool = True
    # the freshest probed load signals (the pair's status: its scheduler's
    # stall-fill ratio and the oldest collection's progress age)
    stall_fill_ratio: float = 0.0
    max_progress_age_s: float = 0.0
    last_seen_s: float = 0.0

    def addr(self, which: int) -> tuple:
        return (self.host0, self.port0) if which == 0 else (self.host1, self.port1)


class FleetDirectory:
    """The registered pairs and each collection's pair.  All state sits
    behind one asyncio lock: the placer, a probe loop and status readers
    share it on the leader's event loop.  ``emit(event, **fields)``
    receives ``fleet.pairs_dead``."""

    def __init__(self, fleet_dir: str | None = None, emit=None):
        self.fleet_dir = fleet_dir
        self.emit = emit or (lambda event, **kw: None)
        self._hosts: dict = {}
        self._placements: dict = {}
        self._lock = asyncio.Lock()

    # -- registration ---------------------------------------------------------

    async def register(self, pair: HostPair) -> None:
        """Register in process; a name registered again is replaced (a
        restarted pair announces its new boot ids this way)."""
        async with self._lock:
            pair.last_seen_s = time.time()
            self._hosts[pair.name] = pair

    async def scan(self) -> int:
        """Fold the ``<pair>_s<id>.json`` files of ``fleet_dir`` into pairs,
        keeping each pair's load signals.  -> the number of whole pairs.  A
        torn or half-written file is skipped: registration renames a whole
        file into place, so a skip only means a server still starting."""
        if not self.fleet_dir:
            return 0
        halves: dict = {}
        try:
            names = sorted(os.listdir(self.fleet_dir))
        except OSError:
            return 0
        for fn in names:
            if not fn.endswith(".json") or "_s" not in fn:
                continue
            try:
                with open(os.path.join(self.fleet_dir, fn)) as f:
                    doc = json.load(f)
                pair = str(doc["pair"])
                sid = int(doc["server_id"])
            except (OSError, ValueError, KeyError):
                continue
            halves.setdefault(pair, {})[sid] = doc
        n = 0
        async with self._lock:
            for pair, by_id in sorted(halves.items()):
                if 0 not in by_id or 1 not in by_id:
                    continue
                d0, d1 = by_id[0], by_id[1]
                prev = self._hosts.get(pair)
                row = HostPair(name=pair, host0=str(d0.get("host", "")),
                               port0=int(d0.get("port", 0)), host1=str(d1.get("host", "")),
                               port1=int(d1.get("port", 0)), boot0=str(d0.get("boot_id", "")),
                               boot1=str(d1.get("boot_id", "")),
                               capacity=int(d0.get("capacity", 4)), last_seen_s=time.time())
                if prev is not None:
                    row.stall_fill_ratio = prev.stall_fill_ratio
                    row.max_progress_age_s = prev.max_progress_age_s
                self._hosts[pair] = row
                n += 1
        return n

    # -- load signals -----------------------------------------------------------

    async def note_load(self, name: str, *, stall_fill_ratio: float = 0.0,
                        max_progress_age_s: float = 0.0) -> None:
        """Record a pair's freshest load signals (its ``status`` ``fleet``
        section's ``load``)."""
        async with self._lock:
            row = self._hosts.get(name)
            if row is None:
                return
            row.stall_fill_ratio = float(stall_fill_ratio)
            row.max_progress_age_s = float(max_progress_age_s)
            row.last_seen_s = time.time()

    async def probe(self, probe_fn) -> list:
        """``await probe_fn(name) -> {"boot0", "boot1", ...}`` for every live
        pair.  Any exception, or a boot id changed since registration, marks
        the pair dead (a restarted secure endpoint cannot continue a
        collection without the leader's re-seed; the fleet treats both
        alike).  ``probe_fn`` must bound its own dial and call: a pair that
        was killed is otherwise seen only after TCP keepalive.  -> the names
        newly marked dead, whose collections the caller fails over."""
        async with self._lock:
            live = [(p.name, p.boot0, p.boot1) for p in self._hosts.values() if p.alive]
        died = []
        for name, boot0, boot1 in live:
            try:
                got = await probe_fn(name)
            except Exception:  # a dead host fails its probe in every way there is
                died.append(name)
                continue
            if ((boot0 and str(got.get("boot0", boot0)) != boot0)
                    or (boot1 and str(got.get("boot1", boot1)) != boot1)):
                died.append(name)
        if died:
            async with self._lock:
                for name in died:
                    row = self._hosts.get(name)
                    if row is not None:
                        row.alive = False
            self.emit("fleet.pairs_dead", pairs=sorted(died))
        return died

    async def mark_dead(self, name: str) -> None:
        async with self._lock:
            row = self._hosts.get(name)
            if row is not None:
                row.alive = False

    # -- placement --------------------------------------------------------------

    async def place(self, session: str, *, exclude: tuple = ()) -> HostPair:
        """Place ``session`` on the least-loaded live pair not in
        ``exclude`` (the module doc's order) and record it."""
        async with self._lock:
            placed: dict = {}
            for p in self._placements.values():
                placed[p] = placed.get(p, 0) + 1
            best, best_key = None, None
            for row in self._hosts.values():
                if not row.alive or row.name in exclude:
                    continue
                key = (placed.get(row.name, 0) / max(1, row.capacity), row.stall_fill_ratio,
                       row.max_progress_age_s, row.name)
                if best_key is None or key < best_key:
                    best, best_key = row, key
            if best is None:
                raise RuntimeError("fleet: no live pair to place onto")
            self._placements[session] = best.name
            return best

    async def placement_of(self, session: str) -> str | None:
        async with self._lock:
            return self._placements.get(session)

    async def move(self, session: str, name: str) -> None:
        async with self._lock:
            self._placements[session] = name

    async def release(self, session: str) -> None:
        async with self._lock:
            self._placements.pop(session, None)

    async def orphans_of(self, name: str) -> list:
        """The collections placed on ``name`` (a dead pair's, to re-place)."""
        async with self._lock:
            return sorted(s for s, p in self._placements.items() if p == name)

    async def pairs(self) -> list:
        async with self._lock:
            return [dataclasses.replace(p)
                    for p in sorted(self._hosts.values(), key=lambda r: r.name)]

    async def status(self) -> dict:
        async with self._lock:
            return {"pairs": {p.name: {"alive": p.alive, "boot0": p.boot0, "boot1": p.boot1,
                                       "capacity": p.capacity,
                                       "stall_fill_ratio": round(p.stall_fill_ratio, 6),
                                       "max_progress_age_s": round(p.max_progress_age_s, 3)}
                              for p in sorted(self._hosts.values(), key=lambda r: r.name)},
                    "placements": dict(sorted(self._placements.items()))}


def status_probe(pairs: dict, budget_s: float = 5.0):
    """A ``probe_fn`` for :meth:`FleetDirectory.probe` over ``pairs``
    ({name: :class:`HostPair`}): the two servers' boot ids from ``status``,
    both dials and both calls within ``budget_s`` in all, so a killed pair
    shows as a timeout or a refused dial within the budget, not after TCP
    keepalive (about two minutes)."""
    from .rpc import CollectorClient

    async def probe(name: str) -> dict:
        pair = pairs[name]

        async def boots() -> dict:
            out = {}
            for i in (0, 1):
                c = await CollectorClient.connect(*pair.addr(i))
                try:
                    out[f"boot{i}"] = (await c.call("status"))["boot_id"]
                finally:
                    await c.aclose()
            return out

        return await asyncio.wait_for(boots(), budget_s)

    return probe


class FleetPlacer:
    """The leader's scheduler over a :class:`FleetDirectory`.  It decides
    where a collection goes, brackets each move with
    ``migration_inflight_since`` (the wall clock while a move runs, 0.0
    otherwise, on both outcomes: a failed migration leaves the source
    authoritative) and keeps the placements true; ``counters`` keeps
    ``FLEET_COUNTERS``.  ``emit`` receives ``fleet.placed``,
    ``fleet.migrated`` and ``fleet.failed_over``."""

    def __init__(self, directory: FleetDirectory, emit=None):
        self.directory = directory
        self.emit = emit or (lambda event, **kw: None)
        self.counters = dict.fromkeys(FLEET_COUNTERS, 0)
        self.migration_inflight_since = 0.0

    async def place(self, session: str, *, exclude: tuple = ()) -> HostPair:
        pair = await self.directory.place(session, exclude=exclude)
        self.counters["placement_decisions"] += 1
        self.emit("fleet.placed", session=session, pair=pair.name)
        return pair

    async def migrate(self, ingest, new_lead, *, session: str, dest: str) -> dict:
        """Live-migrate ``ingest``'s collection onto ``new_lead``'s pair
        (``dest``)."""
        self.migration_inflight_since = time.time()
        try:
            stats = await ingest.migrate(new_lead)
        finally:
            self.migration_inflight_since = 0.0
        self.counters["session_migrations"] += 1
        self.counters["placement_decisions"] += 1
        await self.directory.move(session, dest)
        self.emit("fleet.migrated", session=session, dest=dest, **stats)
        return stats

    async def failover(self, ingest, new_lead, *, session: str, dest: str,
                       level: int = -1) -> dict:
        """Recover a collection of a dead pair onto ``new_lead``'s pair
        (``dest``) from its newest checkpoint (``level``)."""
        self.migration_inflight_since = time.time()
        try:
            stats = await ingest.failover_to(new_lead, level=level)
        finally:
            self.migration_inflight_since = 0.0
        self.counters["session_failovers"] += 1
        self.counters["placement_decisions"] += 1
        await self.directory.move(session, dest)
        self.emit("fleet.failed_over", session=session, dest=dest, **stats)
        return stats

    async def recover_dead_pair(self, name: str, make_ingest, *, level: int = -1) -> dict:
        """Fail every collection placed on dead pair ``name`` over to the
        least-loaded survivor.  ``make_ingest(session, dest pair)`` ->
        ``(ingest, new_lead)``: the caller builds the connections.
        -> {session: the failover's stats}."""
        moved = {}
        for session in await self.directory.orphans_of(name):
            dest = await self.place(session, exclude=(name,))
            ingest, new_lead = await make_ingest(session, dest)
            moved[session] = await self.failover(ingest, new_lead, session=session,
                                                 dest=dest.name, level=level)
        return moved

    def status(self) -> dict:
        return dict(self.counters, migration_inflight_since=self.migration_inflight_since)
