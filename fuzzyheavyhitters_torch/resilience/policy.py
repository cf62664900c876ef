"""Retry and deadline policy: the port's copy of the JAX package's
``resilience/policy.py``, as far as dialing, the client's replay loop,
verb budgets and the leader's span retry need it.

- **Full jitter**: the k-th delay is ``uniform(0, min(cap, base·factor^k))``,
  so two dialers of one server do not retry in lockstep.
- **Deadlines compose with retries**: a :class:`Deadline` is one
  wall-clock budget shared by every attempt of a call (dial, resend,
  response), not a per-attempt timeout.
- **Classification**: transport-shaped failures (reset, EOF, refused,
  timeout, a torn frame) are transient and redialed or replayed; anything
  else (a server's ``__error__`` response, a refused request) is fatal to
  a retry loop.
"""

from __future__ import annotations

import asyncio
import pickle
import random
import time
from dataclasses import dataclass, field

from .. import obs

# asyncio.TimeoutError aliases TimeoutError only from 3.11: list both
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (
    ConnectionError,
    EOFError,  # covers asyncio.IncompleteReadError
    OSError,
    TimeoutError,
    asyncio.TimeoutError,
    pickle.UnpicklingError,  # torn/corrupt frame == transport loss
)


class Deadline:
    """A wall-clock budget anchored at construction; ``None`` is unbounded."""

    __slots__ = ("budget_s", "_t0")

    def __init__(self, budget_s: float | None):
        self.budget_s = budget_s
        self._t0 = time.monotonic()

    def remaining(self) -> float | None:
        """Seconds left (clamped at 0.0), or None when unbounded."""
        if self.budget_s is None:
            return None
        return max(0.0, self.budget_s - (time.monotonic() - self._t0))

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    async def wait_for(self, aw):
        """``asyncio.wait_for`` bounded by what is left of this budget."""
        return await asyncio.wait_for(aw, self.remaining())


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter.  ``attempts`` counts tries
    (1 = no retry)."""

    base_s: float = 0.05
    cap_s: float = 2.0
    factor: float = 2.0
    attempts: int = 8

    def delay(self, attempt: int) -> float:
        """Backoff before try ``attempt + 1`` (attempt is 0-indexed)."""
        return min(self.cap_s, self.base_s * (self.factor ** attempt)) * random.random()


@dataclass(frozen=True)
class VerbBudgets:
    """Per-verb wall-clock budgets of control-plane calls: loud failure on
    a scale of minutes instead of an infinite hang, far above any
    legitimate latency."""

    default_s: float = 1800.0
    per_verb: dict = field(
        default_factory=lambda: {"reset": 300.0, "__hello__": 60.0, "status": 60.0,
                                 "plane_reset": 600.0}
    )

    def budget(self, verb: str) -> float:
        return float(self.per_verb.get(verb, self.default_s))

    def deadline(self, verb: str) -> Deadline:
        return Deadline(self.budget(verb))


async def retry_async(fn, policy: RetryPolicy):
    """``await fn()`` under ``policy``: transient failures back off and
    retry until the attempts run out; fatal failures and exhaustion
    re-raise the last error."""
    for attempt in range(1, policy.attempts + 1):
        try:
            return await fn()
        except TRANSIENT_ERRORS as e:
            if attempt == policy.attempts:
                raise
            delay = policy.delay(attempt - 1)
            obs.emit("resilience.retry", severity="debug", attempt=attempt,
                     delay_s=round(delay, 4), error=f"{type(e).__name__}: {e}")
            await asyncio.sleep(delay)


# ~10 s of redialing (undithered envelope 0.05·(1+2+4+8+16) + 2·4 ≈ 9.6 s)
DIAL_POLICY = RetryPolicy(base_s=0.05, cap_s=2.0, factor=2.0, attempts=10)

# one TCP connect attempt: a localhost/LAN dial not done in 5 s is dead
DIAL_TIMEOUT_S = 5.0

# the leader's per-span retry (``leader_rpc.RpcLeader._shard_call``): few
# attempts, since each rides the client's own redial and replay, and a span
# that fails three times is the supervised crawl's rollback to handle
SHARD_POLICY = RetryPolicy(base_s=0.05, cap_s=1.0, factor=2.0, attempts=3)
