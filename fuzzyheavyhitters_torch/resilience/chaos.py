"""Chaos proxy: deterministic fault injection between crawl sockets (the
port's copy of the frame-level TCP proxy of the JAX package's
``resilience/chaos.py``).

An asyncio TCP proxy that reads the control and data planes' framing (the
8-byte little-endian length prefix of ``protocol/rpc.py``) and so fires
faults at exact frame boundaries: "sever the leader's link right after the
12th request" is reproducible where byte- or time-triggered faults are not.

Fault grammar (``;``-separated clauses)::

    <link>:<action>@msg=<N>[,key=value...]

    link    label the proxy was constructed with (e.g. ctl0, ctl1, plane)
    action  sever | delay | blackhole | truncate | flood | slowclient
    msg=N   fire when the Nth frame (1-indexed, per direction) arrives
    dir=    c2s (default) | s2c: which direction's frame counter triggers
    ms=M    delay/slowclient: forward M milliseconds late (default 200)
    count=K blackhole: drop K consecutive frames then resume;
            flood: deliver K extra copies of the trigger frame;
            slowclient: trickle K consecutive frames (default 1)

Actions:

- ``sever``: close both sides mid-stream; the listener stays up, so a
  reconnecting client redials through the same proxy.
- ``delay``: hold one frame ``ms`` before forwarding it.
- ``blackhole``: read and drop ``count`` frames, the connection open (the
  caller's verb budget must turn the wait into a timeout).
- ``truncate``: forward half of the frame's payload, then sever (a torn
  frame must read as a transport loss).
- ``flood``: deliver the trigger frame 1 + ``count`` times (a duplicated
  verb frame must be absorbed by the server's replay dedup).
- ``slowclient``: forward the next ``count`` frames ``ms`` late each.

Frame ordinals count per connection and per direction, but the clauses are
consumed by the proxy as a whole: a sever that fired does not re-arm on
the redial.

The mesh drills (:class:`MeshChaos`) inject faults into the device-mesh
crawl of ``parallel/mesh.py`` at the level boundaries its leader crosses,
and into a collector server's data shards at each crawl verb's entry
(``protocol/rpc.py``), with their own grammar (below).  The host drills
(:class:`HostChaos`) lose a whole collector pair at a window boundary, for
the fleet's failover (``protocol/fleet.py``).  :class:`ChaosLinks` bundles
the three proxies of one pair (leader to server 0, leader to server 1, the
data plane) built from one fault spec.
"""

from __future__ import annotations

import asyncio
import struct
import time
from dataclasses import dataclass, field

_HDR = struct.Struct("<Q")  # protocol/rpc.py's framing

_ACTIONS = ("sever", "delay", "blackhole", "truncate", "flood", "slowclient")
_DIRS = ("c2s", "s2c")


@dataclass(frozen=True)
class FaultSpec:
    link: str
    action: str
    at_msg: int  # 1-indexed frame ordinal that triggers the fault
    direction: str = "c2s"
    ms: int = 200
    count: int = 1

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}")
        if self.direction not in _DIRS:
            raise ValueError(f"unknown chaos direction {self.direction!r}")
        if self.at_msg < 1:
            raise ValueError("msg= trigger is 1-indexed")


def parse_faults(spec: str | None) -> list[FaultSpec]:
    """Parse a fault spec (the grammar above).  A blank spec is no faults;
    a malformed clause raises ``ValueError``: a schedule that silently did
    nothing would pass a recovery test for the wrong reason."""
    out: list[FaultSpec] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            head, args = clause.split("@", 1)
            link, action = head.split(":", 1)
        except ValueError:
            raise ValueError(
                f"bad chaos clause {clause!r} (want link:action@msg=N[,k=v...])") from None
        kw: dict = {}
        for part in args.split(","):
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if k == "msg":
                kw["at_msg"] = int(v)
            elif k == "dir":
                kw["direction"] = v
            elif k in ("ms", "count"):
                kw[k] = int(v)
            else:
                raise ValueError(f"unknown chaos arg {k!r} in {clause!r}")
        if "at_msg" not in kw:
            raise ValueError(f"chaos clause {clause!r} missing msg= trigger")
        out.append(FaultSpec(link=link.strip(), action=action.strip(), **kw))
    return out


class ChaosProxy:
    """One listener forwarding to one target, applying the clauses whose
    ``link`` is this proxy's label.  Construct, ``await start()``, point
    the client at ``listen_port``.  ``fired`` lists ``(action, direction,
    msg)`` of every fault that fired."""

    def __init__(self, listen_host: str, listen_port: int, target_host: str,
                 target_port: int, faults: list[FaultSpec] | None = None, link: str = "link"):
        self.listen_host, self.listen_port = listen_host, listen_port
        self.target_host, self.target_port = target_host, target_port
        self.link = link
        self.faults = [f for f in (faults or []) if f.link == link]
        self._srv = None
        self._conns: set = set()
        self._pumps: set = set()
        # [spec, fires left]: blackhole and slowclient fire once per frame for
        # count frames, the others once
        self._armed = [[f, f.count if f.action in ("blackhole", "slowclient") else 1]
                       for f in self.faults]
        self.frames = {"c2s": 0, "s2c": 0}  # totals over every connection
        self.fired: list = []

    async def start(self) -> "ChaosProxy":
        self._srv = await asyncio.start_server(self._on_client, self.listen_host,
                                               self.listen_port)
        return self

    async def stop(self) -> None:
        if self._srv is not None:
            self._srv.close()
        self.sever_now()
        for t in list(self._pumps):
            t.cancel()
        await asyncio.gather(*self._pumps, return_exceptions=True)
        if self._srv is not None:
            await self._srv.wait_closed()

    def sever_now(self) -> None:
        """Cut every live connection (the listener stays up)."""
        for pair in list(self._conns):
            self._sever_pair(pair)

    async def _on_client(self, c_reader, c_writer):
        try:
            s_reader, s_writer = await asyncio.wait_for(
                asyncio.open_connection(self.target_host, self.target_port), 5.0)
        except (OSError, asyncio.TimeoutError):
            c_writer.close()
            return
        pair = (c_writer, s_writer)
        self._conns.add(pair)
        counts = {"c2s": 0, "s2c": 0}
        for direction, rd, wr in (("c2s", c_reader, s_writer), ("s2c", s_reader, c_writer)):
            t = asyncio.ensure_future(self._pump(counts, direction, rd, wr, pair))
            self._pumps.add(t)
            t.add_done_callback(self._pumps.discard)

    def _sever_pair(self, pair) -> None:
        for w in pair:
            if not w.is_closing():
                w.close()
        self._conns.discard(pair)

    def _fault_for(self, direction: str, msg_no: int) -> FaultSpec | None:
        for ent in self._armed:
            f, left = ent
            if left > 0 and f.direction == direction and msg_no >= f.at_msg:
                ent[1] -= 1
                return f
        return None

    async def _pump(self, counts, direction, reader, writer, pair):
        """Forward frames one at a time, consulting the schedule at each
        frame boundary.  A transport error on either side severs the pair
        (a half-open proxy would hide a real sever)."""
        try:
            while True:
                hdr = await reader.readexactly(_HDR.size)
                (n,) = _HDR.unpack(hdr)
                body = await reader.readexactly(n)
                counts[direction] += 1
                self.frames[direction] += 1
                fault = self._fault_for(direction, counts[direction])
                if fault is not None:
                    self.fired.append((fault.action, direction, counts[direction]))
                    if fault.action == "sever":
                        self._sever_pair(pair)
                        return
                    if fault.action == "blackhole":
                        continue
                    if fault.action == "truncate":
                        writer.write(hdr + body[:max(1, n // 2)])
                        await writer.drain()
                        self._sever_pair(pair)
                        return
                    if fault.action in ("delay", "slowclient"):
                        await asyncio.sleep(fault.ms / 1000.0)
                    if fault.action == "flood":  # count extra copies, then the original
                        for _ in range(max(1, fault.count)):
                            writer.write(hdr + body)
                writer.write(hdr + body)
                await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError, OSError):
            self._sever_pair(pair)


# ---------------------------------------------------------------------------
# Mesh chaos: fault injection for parallel/mesh.py
#
# The mesh has no socket to proxy: its exchange is collectives between the
# shards.  Faults fire at the level boundaries that MeshLeader.run_supervised
# crosses anyway (it asks the injector before each level), as surrogates of
# the real failures:
#
# - ``drop``:  a dropped data-parallel shard.  The level's collective result
#   cannot be trusted, the device state can: re-run the level.
# - ``kill``:  a participant killed mid-collective.  The injector clobbers
#   the runner's frontier and child cache (the participant's memory is
#   gone), so only a checkpoint restore recovers.
# - ``delay``: a slow participant.  The level stalls ``ms`` milliseconds and
#   completes; no recovery may follow.
#
# Grammar (``FHH_MESH_FAULTS``): ``mesh:<action>@level=<N>[,ms=M]``,
# ';'-separated, each clause consumed once like the proxy's.
# ---------------------------------------------------------------------------

_MESH_ACTIONS = ("drop", "kill", "delay")


class MeshFaultError(RuntimeError):
    """An injected (or detected) mesh fault; ``state_lost`` tells the
    supervisor whether the device-resident frontier survived (drop: re-run
    the level) or not (kill: restore a checkpoint)."""

    def __init__(self, msg: str, state_lost: bool = False):
        super().__init__(msg)
        self.state_lost = state_lost


@dataclass(frozen=True)
class MeshFaultSpec:
    action: str
    at_level: int
    ms: int = 200

    def __post_init__(self):
        if self.action not in _MESH_ACTIONS:
            raise ValueError(f"unknown mesh chaos action {self.action!r}")
        if self.at_level < 0:
            raise ValueError("level= trigger must be >= 0")


def parse_mesh_faults(spec: str | None) -> list[MeshFaultSpec]:
    """Parse an ``FHH_MESH_FAULTS`` spec (grammar above).  A blank spec is
    no fault; a malformed clause raises ValueError."""
    out: list[MeshFaultSpec] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            head, args = clause.split("@", 1)
            link, action = head.split(":", 1)
        except ValueError:
            raise ValueError(f"bad mesh chaos clause {clause!r} "
                             "(want mesh:action@level=N[,ms=M])") from None
        if link.strip() != "mesh":
            raise ValueError(f"mesh chaos clause {clause!r} must target 'mesh'")
        kw: dict = {}
        for part in args.split(","):
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if k == "level":
                kw["at_level"] = int(v)
            elif k == "ms":
                kw["ms"] = int(v)
            else:
                raise ValueError(f"unknown mesh chaos arg {k!r} in {clause!r}")
        if "at_level" not in kw:
            raise ValueError(f"mesh chaos clause {clause!r} missing level=")
        out.append(MeshFaultSpec(action=action.strip(), **kw))
    return out


class MeshChaos:
    """Consumed-once mesh fault schedule.  :meth:`before_level` is the hook
    ``MeshLeader.run_supervised`` calls at each level's entry, and a
    collector server at each crawl verb's (its ``runner`` the server); a clause
    whose ``at_level`` has been reached fires exactly once (a re-run level
    does not trigger it again, so the recovery makes progress).  ``emit``
    receives ``resilience.mesh_chaos_fired`` events."""

    def __init__(self, faults: list | None = None, emit=None):
        self._armed: list[MeshFaultSpec] = list(faults or [])
        self.fired: list[tuple[str, int]] = []  # (action, level)
        self.emit = emit or (lambda event, **kw: None)

    def before_level(self, runner, level: int) -> None:
        for f in list(self._armed):
            if level < f.at_level:
                continue
            self._armed.remove(f)
            self.fired.append((f.action, level))
            self.emit("resilience.mesh_chaos_fired", action=f.action, level=level)
            if f.action == "delay":
                time.sleep(f.ms / 1000.0)
                continue
            if f.action == "kill":
                # the participant's memory is gone: clobber the frontier and
                # the child cache (a mesh runner's ``_children``, a collector
                # server's ``children``) so any recovery short of a
                # checkpoint restore fails loudly
                runner.frontier = None
                for cache in ("_children", "children"):
                    if hasattr(runner, cache):
                        setattr(runner, cache, None)
                raise MeshFaultError(
                    f"mesh participant killed mid-collective at level {level}",
                    state_lost=True)
            raise MeshFaultError(f"data-parallel shard dropped at level {level}",
                                 state_lost=False)


# ---------------------------------------------------------------------------
# Host chaos: a whole collector pair lost (the fleet's failover drill)
#
# Above the link (ChaosProxy severs one connection) and the device (MeshChaos
# clobbers one participant) sits the host: both servers of a pair gone at
# once, a rack's power or a preempted pair of machines.  The windowed ingest
# driver asks the injector at its window boundaries; a clause whose window
# has been reached fires once, and the caller kills the whole pair.  The
# fleet's probe then sees dead boot ids and fails the pair's sessions over
# to a surviving pair from their newest checkpoints (protocol/fleet.py).
#
# Grammar: ``host:kill@window=<N>``, ';'-separated, each clause consumed
# once like the mesh clauses.
# ---------------------------------------------------------------------------

_HOST_ACTIONS = ("kill",)


@dataclass(frozen=True)
class HostFaultSpec:
    action: str
    at_window: int

    def __post_init__(self):
        if self.action not in _HOST_ACTIONS:
            raise ValueError(f"unknown host chaos action {self.action!r}")
        if self.at_window < 0:
            raise ValueError("window= trigger must be >= 0")


def parse_host_faults(spec: str | None) -> list[HostFaultSpec]:
    """Parse a host fault spec (grammar above).  A blank spec is no fault;
    a malformed clause raises ValueError with the JAX package's text."""
    out: list[HostFaultSpec] = []
    for clause in (spec or "").split(";"):
        clause = clause.strip()
        if not clause:
            continue
        try:
            head, args = clause.split("@", 1)
            link, action = head.split(":", 1)
        except ValueError:
            raise ValueError(f"bad host chaos clause {clause!r} "
                             "(want host:kill@window=N)") from None
        if link.strip() != "host":
            raise ValueError(f"host chaos clause {clause!r} must target 'host'")
        kw: dict = {}
        for part in args.split(","):
            k, _, v = part.partition("=")
            k, v = k.strip(), v.strip()
            if k == "window":
                kw["at_window"] = int(v)
            else:
                raise ValueError(f"unknown host chaos arg {k!r} in {clause!r}")
        if "at_window" not in kw:
            raise ValueError(f"host chaos clause {clause!r} missing window=")
        out.append(HostFaultSpec(action=action.strip(), **kw))
    return out


class HostChaos:
    """Consumed-once host-pair fault schedule.  :meth:`before_window`
    returns True when a clause fires at this boundary; the caller then kills
    the whole pair (two servers of one process in the tests, two processes
    on the card), so the injector itself knows nothing of processes.
    ``emit`` receives ``resilience.host_chaos_fired`` events."""

    def __init__(self, faults: list | None = None, emit=None):
        self._armed: list[HostFaultSpec] = list(faults or [])
        self.fired: list[tuple[str, int]] = []  # (action, window)
        self.emit = emit or (lambda event, **kw: None)

    def before_window(self, window: int) -> bool:
        hit = False
        for f in list(self._armed):
            if window < f.at_window:
                continue
            self._armed.remove(f)
            self.fired.append((f.action, window))
            self.emit("resilience.host_chaos_fired", action=f.action, window=window)
            hit = True
        return hit


@dataclass
class ChaosLinks:
    """The three links of one pair behind proxies, from one fault spec:
    leader to server 0 (``ctl0``), leader to server 1 (``ctl1``) and the data
    plane (``plane``), listening on ``base_port`` and the two ports after
    it.  ``await start()`` brings all three up; :meth:`addr` gives the
    endpoint the leader's or a server's config should dial."""

    listen_host: str
    base_port: int  # three consecutive ports: ctl0, ctl1, plane
    ctl0_target: tuple[str, int]
    ctl1_target: tuple[str, int]
    plane_target: tuple[str, int]
    faults: list[FaultSpec] = field(default_factory=list)
    proxies: dict = field(default_factory=dict)

    _LINKS = ("ctl0", "ctl1", "plane")

    async def start(self) -> "ChaosLinks":
        targets = (self.ctl0_target, self.ctl1_target, self.plane_target)
        for i, (link, tgt) in enumerate(zip(self._LINKS, targets)):
            self.proxies[link] = await ChaosProxy(self.listen_host, self.base_port + i, tgt[0],
                                                  tgt[1], self.faults, link=link).start()
        return self

    async def stop(self) -> None:
        for p in self.proxies.values():
            await p.stop()

    def addr(self, link: str) -> tuple[str, int]:
        return self.listen_host, self.base_port + self._LINKS.index(link)
