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
the redial.  The JAX package's mesh and host drills (``MeshChaos``,
``HostChaos``) belong to the multi-card server and the fleet, not ported
yet.
"""

from __future__ import annotations

import asyncio
import struct
from dataclasses import dataclass

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
