"""Tenant scheduling: interleave device work across collection sessions
(the port of ``fuzzyheavyhitters_tpu/protocol/tenancy.py``).

While one collection's level waits on the data plane, the card sits idle.
Each session serializes its own verbs on its own lock, so two sessions'
verbs already interleave on the event loop; this module makes that
interleaving scheduled (FIFO device turns) and observable (stall fills):

- :class:`TenantScheduler`: ``device_turn(key)`` brackets a session's
  device stage (one card: turns serialize FIFO across sessions, so one
  tenant's dispatch burst cannot starve another's), and ``wire_wait(key)``
  brackets its data-plane waits.  A device turn taken while another
  session waits on the wire is a **stall fill**, counted per session and
  in total and reported in ``status`` and ``server.exit``.
- The warm ladder (:func:`warmed`, :func:`mark_warmed`): the process-level
  set of warmed shapes.  Once any session warmed a shape, a collection of
  the same shape skips that warm run (``ladder_hits``): the kernels are
  built once a process, and the CUDA caching allocator keeps the pools a
  warm run reserved.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
import time


class TenantScheduler:
    """FIFO device turns and stall-fill accounting (module doc).  All state
    changes on the owning server's event loop, so the counters need no
    lock."""

    def __init__(self):
        self._device_lock = asyncio.Lock()
        # session key -> depth of its active wire waits (recovery paths may
        # nest, so a count is the safe shape)
        self._wire: dict = {}
        self.device_turns = 0
        self.stall_fills = 0
        self.turns_by_session: dict = {}
        self.fills_by_session: dict = {}
        # session key -> wall clock of its last device turn: the oldest is
        # the "is anything starving here" signal (fleet_load)
        self.last_progress_s: dict = {}

    def _others_on_wire(self, key: str) -> bool:
        return any(n > 0 and k != key for k, n in self._wire.items())

    def _note_turn(self, key: str) -> None:
        self.device_turns += 1
        self.turns_by_session[key] = self.turns_by_session.get(key, 0) + 1
        self.last_progress_s[key] = time.time()
        if self._others_on_wire(key):
            self.stall_fills += 1
            self.fills_by_session[key] = self.fills_by_session.get(key, 0) + 1

    def device_turn(self, key: str, count: bool = True):
        """Async context manager bracketing one session's device stage.
        Turns serialize FIFO across sessions; one taken while another
        session waits on the wire counts a stall fill.  ``count`` False
        keeps the serialization but skips the accounting: the stage ran,
        and was counted, at frame arrival (:meth:`note_dispatch`)."""
        return _DeviceTurn(self, key, count)

    @contextlib.contextmanager
    def wire_wait(self, key: str):
        """Mark a session as blocked on the data plane."""
        self._wire[key] = self._wire.get(key, 0) + 1
        try:
            yield
        finally:
            n = self._wire.get(key, 1) - 1
            if n <= 0:
                self._wire.pop(key, None)
            else:
                self._wire[key] = n

    def note_dispatch(self, key: str) -> None:
        """Turn accounting for a device stage that cannot await (the
        frame-arrival pre-expand, which must stay atomic on the loop)."""
        self._note_turn(key)

    def wire_waiting(self) -> list:
        return sorted(k for k, n in self._wire.items() if n > 0)

    def forget(self, key: str) -> None:
        """Drop one session's rows: a retired tenant must not hold the
        progress-age signal high for ever."""
        self.turns_by_session.pop(key, None)
        self.fills_by_session.pop(key, None)
        self.last_progress_s.pop(key, None)

    def fleet_load(self, now: float | None = None) -> dict:
        """The placement signals: the stall-fill ratio (how contended the
        card is) and the age of the least recently progressing session."""
        if now is None:
            now = time.time()
        ages = [now - t for t in self.last_progress_s.values()]
        return {"stall_fill_ratio": round(self.stall_fills / max(1, self.device_turns), 6),
                "max_progress_age_s": round(max(ages, default=0.0), 3)}

    def stats(self) -> dict:
        return {"device_turns": self.device_turns, "stall_fills": self.stall_fills,
                "fill_ratio": round(self.stall_fills / max(1, self.device_turns), 6),
                "turns_by_session": dict(sorted(self.turns_by_session.items())),
                "fills_by_session": dict(sorted(self.fills_by_session.items())),
                "wire_waiting": self.wire_waiting()}


class _DeviceTurn:
    __slots__ = ("_sched", "_key", "_count")

    def __init__(self, sched: TenantScheduler, key: str, count: bool = True):
        self._sched = sched
        self._key = key
        self._count = count

    async def __aenter__(self):
        await self._sched._device_lock.acquire()
        if self._count:
            self._sched._note_turn(self._key)
        return self

    async def __aexit__(self, exc_type, exc, tb):
        self._sched._device_lock.release()
        return False


# -- the warm ladder: the process-level registry of warmed shapes ---------
# Keys are tuples built by rpc.CollectorServer._warm_key from everything
# that changes a kernel launch's shape or path, the server's boot id among
# them: a server's collections share what it warmed.

_WARMED: set = set()
_WARM_LOCK = threading.Lock()  # one event loop a server, but tests probe from threads


def warmed(key: tuple) -> bool:
    """True when some session in this process already warmed ``key``."""
    with _WARM_LOCK:
        return key in _WARMED


def mark_warmed(key: tuple) -> None:
    with _WARM_LOCK:
        _WARMED.add(key)


def ladder_size() -> int:
    with _WARM_LOCK:
        return len(_WARMED)


def ladder_reset() -> None:
    """Forget every warmed shape (the skip bookkeeping only)."""
    with _WARM_LOCK:
        _WARMED.clear()
