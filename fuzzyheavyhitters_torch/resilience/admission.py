"""Admission control for the streaming ingest front door (the port's copy
of the JAX package's ``resilience/admission.py``).

The overload vocabulary every ingest path speaks (``protocol/rpc.py``'s
``submit_keys`` verb is the consumer): a submission is ADMITTED into the
window pool, SHED (reservoir mode replaced it or dropped it: the pool stays
a seeded uniform sample of everything offered), or REJECTED with a
retryable ``Overloaded`` verdict the client backs off on.  The server
degrades gracefully: bounded pools, explicit verdicts, deterministic
sampling, never unbounded queueing or silent drops.

Pieces:

- :class:`TokenBucket`: keys-per-second rate limiting with an injectable
  clock, so tests drive it deterministically (:class:`ManualClock`) and
  production uses ``time.monotonic``.
- :class:`WindowAdmission`: one ingest window's admission state, the
  per-client key quotas, the bounded pool occupancy and, in reservoir shed
  mode, the seeded incremental reservoir of
  :mod:`fuzzyheavyhitters_torch.native` deciding slot placement.
- :class:`AdmissionController`: the server-wide gate, the temporal rate
  limit (shared across windows: rate is about time, not window identity)
  with the per-window state; ``admit`` returns a :class:`Verdict`.

Determinism: given the same seed and the same sequence of submissions,
every decision (reservoir slots included) is identical.  That is what lets
the gate server's verdicts be mirrored to its peer and replayed after a
restart (the reservoir's state is checkpointable through
``Reservoir.state()``).

An ``Overloaded`` verdict is not an error: it is a successful RPC response
(it replays identically from the dedup cache), and each new client attempt
is a new call, so a backed-off retry runs admission again against refilled
tokens instead of being answered with a stale cached rejection.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

from .. import native

# shed policies (Config.ingest_shed)
SHED_REJECT = "reject"
SHED_RESERVOIR = "reservoir"
SHED_POLICIES = (SHED_REJECT, SHED_RESERVOIR)


class ManualClock:
    """Deterministic clock for tests: ``advance(s)`` moves time forward;
    calling the instance returns the current reading (the same shape as
    ``time.monotonic``)."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def advance(self, s: float) -> None:
        self._t += float(s)

    def __call__(self) -> float:
        return self._t


@dataclass
class TokenBucket:
    """Classic token bucket in KEYS (not submissions): ``rate_per_s``
    tokens accrue continuously up to ``burst``; ``try_take(n)`` spends n
    or refuses.  ``wait_s(n)`` names the refill horizon — the retryable
    verdict's ``retry_after_s`` hint, so a backing-off client sleeps an
    informed amount instead of a blind guess."""

    rate_per_s: float
    burst: float
    clock: object = field(default=time.monotonic, repr=False)

    def __post_init__(self):
        if self.rate_per_s <= 0:
            raise ValueError("token bucket rate must be positive")
        self.burst = max(float(self.burst), 1.0)
        self.tokens = self.burst
        self._last = float(self.clock())

    def _refill(self) -> None:
        now = float(self.clock())
        if now > self._last:
            self.tokens = min(
                self.burst, self.tokens + (now - self._last) * self.rate_per_s
            )
        self._last = now

    def try_take(self, n: float) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def wait_s(self, n: float) -> float:
        """Seconds until ``n`` tokens could be available (0 when they
        already are).  Honest by construction: callers reject n > burst
        outright (scope "burst") instead of asking for a horizon the
        bucket can never reach."""
        self._refill()
        return max(0.0, (n - self.tokens) / self.rate_per_s)


@dataclass(frozen=True)
class Verdict:
    """One submission's fate.  ``admitted`` with ``slot is None`` means
    append to the pool in arrival order; ``admitted`` with a slot means
    replace that reservoir slot (shedding its occupant); not admitted
    with ``shed`` means the reservoir dropped this submission (a
    SUCCESSFUL outcome — the pool remains a uniform sample); not admitted
    with a ``scope`` means Overloaded: retryable, back off
    ``retry_after_s`` and try again."""

    admitted: bool
    slot: int | None = None
    shed: bool = False
    scope: str | None = None  # "rate" | "quota" | "capacity"
    retry_after_s: float = 0.0


class WindowAdmission:
    """Per-window admission state: client quota ledger + pool occupancy
    + the reservoir (reservoir shed mode only, created lazily at first
    overflow so under-capacity windows never touch the RNG).

    Reservoir mode requires a FIXED submission chunk size (the first
    admitted submission sets it; mismatched sizes are capacity-rejected
    BEFORE any RNG offer): the slot table then bounds the pool exactly
    (slots x chunk) and slot replacement can never grow it — and the
    reject happens pre-offer, so the sampling stream stays a pure
    function of the admitted-or-offered sequence."""

    def __init__(self, *, max_keys: int, client_quota: int, shed: str,
                 seed: int):
        if shed not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed!r}")
        self.max_keys = int(max_keys)
        self.client_quota = int(client_quota)
        self.shed = shed
        self.seed = int(seed)
        self.client_keys: dict[str, int] = {}
        self.subs = 0  # admitted submissions (reservoir slot capacity)
        self.keys = 0  # keys currently pooled
        self.sub_keys: int | None = None  # fixed chunk size (reservoir)
        self.reservoir: native.Reservoir | None = None
        # draws consumed by journal-replayed verdicts BEFORE the (re-)
        # engagement of the sampler (recovery without a post-engagement
        # checkpoint): the engagement fast-forward includes them so the
        # stream continues where the first life left off
        self.pending_draws = 0

    def _charge(self, client_id: str, n_keys: int) -> None:
        if client_id is not None:
            self.client_keys[client_id] = (
                self.client_keys.get(client_id, 0) + n_keys
            )

    def precheck(self, client_id: str, n_keys: int) -> Verdict | None:
        """READ-ONLY rejection checks, run before the shared rate bucket
        is charged: a submission doomed by its own quota, an impossible
        size, or a full reject-mode window must not drain the tokens
        honest clients are queueing on (a flooder stalls itself, not
        them).  Returns the rejection, or None to proceed."""
        if (
            self.client_quota > 0
            and client_id is not None
            and self.client_keys.get(client_id, 0) + n_keys > self.client_quota
        ):
            return Verdict(False, scope="quota")
        if self.shed == SHED_RESERVOIR:
            if self.sub_keys is not None and n_keys != self.sub_keys:
                # the slot-table bound rests on uniform chunks — a
                # mismatched size can never be admitted to this window
                return Verdict(False, scope="capacity")
            if self.sub_keys is None and n_keys > self.max_keys:
                return Verdict(False, scope="capacity")
        elif self.reservoir is None and self.keys + n_keys > self.max_keys:
            return Verdict(False, scope="capacity")
        return None

    def decide(self, client_id: str, n_keys: int) -> Verdict:
        """The commit half of one submission's decision (run
        :meth:`precheck` first — the controller's ``admit`` does).
        Mutates the ledgers on admit/shed so the decision sequence is
        the state."""
        early = self.precheck(client_id, n_keys)
        if early is not None:
            return early
        if self.reservoir is None and self.keys + n_keys <= self.max_keys:
            self._charge(client_id, n_keys)
            self.keys += n_keys
            self.subs += 1
            if self.shed == SHED_RESERVOIR and self.sub_keys is None:
                self.sub_keys = n_keys
            return Verdict(True, slot=None)
        if self.shed == SHED_REJECT:
            return Verdict(False, scope="capacity")
        # reservoir shed: the pool is FULL — from here on the slot table
        # (capacity = submissions admitted so far) is a uniform sample of
        # every offer.  Deterministic given (seed, offer sequence); the
        # precheck guarantees subs >= 1 and a size-matched chunk here.
        if self.reservoir is None:
            self.reservoir = native.Reservoir(self.subs, self.seed)
            # the fill phase already happened (the appends above): fast-
            # forward the stream past it so offer #subs+1 is the first
            # replacement draw, exactly like a one-shot reservoir's —
            # plus any draws journal-replayed verdicts consumed before
            # this (re-)engagement
            self.reservoir.offer(self.reservoir.k + self.pending_draws)
            self.pending_draws = 0
        slot = int(self.reservoir.offer(1)[0])
        if slot < 0:
            return Verdict(False, shed=True)
        self._charge(client_id, n_keys)
        return Verdict(True, slot=slot)


class AdmissionController:
    """The server-wide front-door gate.  One temporal token bucket across
    windows; per-window state created on first touch via :meth:`window`
    (bounded by the caller — protocol/rpc.py retains a fixed number of
    live windows)."""

    def __init__(self, *, max_window_keys: int, rate_keys_per_s: float = 0.0,
                 burst_keys: int = 4096, client_quota: int = 0,
                 shed: str = SHED_REJECT, seed: int = 0,
                 clock=time.monotonic):
        if max_window_keys <= 0:
            raise ValueError("max_window_keys must be positive (bounded pool)")
        if shed not in SHED_POLICIES:
            raise ValueError(f"unknown shed policy {shed!r}")
        self.max_window_keys = int(max_window_keys)
        self.client_quota = int(client_quota)
        self.shed = shed
        self.seed = int(seed)
        self.bucket = (
            TokenBucket(rate_keys_per_s, burst_keys, clock=clock)
            if rate_keys_per_s > 0
            else None
        )

    def window(self, window: int) -> WindowAdmission:
        return WindowAdmission(
            max_keys=self.max_window_keys,
            client_quota=self.client_quota,
            shed=self.shed,
            # per-window seed: windows sample independently but each is
            # reproducible from (seed, window) alone
            seed=(self.seed * 0x9E3779B9 + int(window)) & ((1 << 64) - 1),
        )

    def admit(self, wa: WindowAdmission, client_id: str,
              n_keys: int) -> Verdict:
        """Read-only prechecks (quota, impossible sizes, full
        reject-mode windows) run FIRST so a doomed submission never
        drains the shared rate bucket — a quota-blocked flooder's
        retries must not convert into rate rejections for honest
        clients.  Then the temporal rate limit, then the window's commit
        decision.  A rejection never touches the window state, so a
        backed-off retry replays against the same deterministic window
        sequence."""
        early = wa.precheck(client_id, n_keys)
        if early is not None:
            return early
        if self.bucket is not None:
            if n_keys > self.bucket.burst:
                # no refill horizon ever covers this chunk: reject with
                # a distinct scope instead of promising a wait that
                # cannot be kept (split the chunk or raise the burst)
                return Verdict(False, scope="burst")
            if not self.bucket.try_take(n_keys):
                return Verdict(
                    False, scope="rate",
                    retry_after_s=self.bucket.wait_s(n_keys),
                )
        return wa.decide(client_id, n_keys)

    async def admit_offloaded(self, wa: WindowAdmission, client_id: str,
                              n_keys: int, *, gate: asyncio.Lock) -> Verdict:
        """:meth:`admit` off the shared event loop: the bucket/quota/
        reservoir arithmetic runs in the default executor behind the
        caller's per-session ``gate``, so a flooding tenant's admission
        math occupies a worker thread, not the server loop — other
        tenants' verbs (and other sessions' admissions) keep
        interleaving.  The gate serializes decisions PER SESSION: the
        determinism contract (module doc) is about the decision
        SEQUENCE, and two interleaved executor runs against one window's
        ledgers would fork it."""
        async with gate:
            loop = asyncio.get_running_loop()
            return await loop.run_in_executor(
                None, self.admit, wa, client_id, n_keys
            )
