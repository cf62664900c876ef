"""Fixed-bucket latency histograms: the SLO instrument of the obs layer (the
port of ``fuzzyheavyhitters_tpu/obs/hist.py``; the bucket bounds are that
module's, so a snapshot of either package merges into the other's).

Counters and gauges cannot express "p95 seal-to-hitters latency" — a
last-write gauge hides the tail and a mean hides everything.  This
module adds the missing shape: a :class:`Histogram` with FIXED,
log-spaced bucket bounds shared by every histogram in every process.
Fixed bounds are the load-bearing choice: two histograms are merged by
summing their bucket counts, with no re-binning and no per-histogram
metadata to reconcile — which is what lets the run report fold the
leader's, both servers', and every per-session registry's observations
of the same metric into one quantile estimate
(:func:`obs.report.run_report`'s ``slo`` section), and lets ``status``
report a live summary without shipping raw samples.

Layout: 5 buckets per decade from 100 µs to 10 000 s (40 log-spaced
bounds, ~58 % wide — quantile estimates are good to about one bucket
width, plenty for SLO work) plus an underflow-free first bucket and an
overflow bucket.  Values are SECONDS; an exact ``max`` rides along so a
single catastrophic outlier is never rounded into a bucket bound.

Quantiles interpolate within the winning bucket's log-space width, so
p50/p95/p99 move smoothly as counts shift instead of jumping from bound
to bound.
"""

from __future__ import annotations

import bisect
import math

# Upper bounds of the finite buckets: 1e-4 * 10^(i/5) for i in 0..40
# (100 µs .. 10 000 s).  Module-level constant — every histogram in
# every process shares it, which is the whole mergeability contract.
BUCKET_BOUNDS: tuple = tuple(
    round(1e-4 * 10 ** (i / 5), 10) for i in range(41)
)
N_BUCKETS = len(BUCKET_BOUNDS) + 1  # + overflow

_QUANTILES = (0.5, 0.95, 0.99)


class Histogram:
    """One latency histogram over the shared :data:`BUCKET_BOUNDS`.
    Exact ``min``/``max`` ride along so quantile estimates clamp to the
    observed range — a single-sample histogram reports its sample, not
    a bucket midpoint."""

    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * N_BUCKETS
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if not math.isfinite(v) or v < 0.0:
            v = 0.0
        self.counts[bisect.bisect_left(BUCKET_BOUNDS, v)] += 1
        self.count += 1
        self.sum += v
        if v > self.max:
            self.max = v
        if v < self.min:
            self.min = v

    # -- merge ------------------------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        if other.min < self.min:
            self.min = other.min
        return self

    @classmethod
    def merged(cls, hists) -> "Histogram":
        out = cls()
        for h in hists:
            if h is not None:
                out.merge(h)
        return out

    # -- quantiles --------------------------------------------------------

    def quantile(self, q: float) -> float | None:
        """Estimated value at quantile ``q`` (0..1); None when empty.
        Interpolates log-linearly inside the winning bucket."""
        if self.count == 0:
            return None
        lo_clamp = self.min if math.isfinite(self.min) else 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            seen += c
            if seen < rank:
                continue
            hi = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else self.max
            if i == 0:
                lo = 0.0
                # first bucket: linear interpolation (log of 0 is not a number)
                frac = max(0.0, min(1.0, 1 - (seen - rank) / c))
                est = lo + frac * (hi - lo)
            else:
                lo = BUCKET_BOUNDS[i - 1]
                if hi <= lo:  # overflow bucket whose max sits on the bound
                    est = hi if hi > 0 else lo
                else:
                    frac = max(0.0, min(1.0, 1 - (seen - rank) / c))
                    est = math.exp(
                        math.log(lo) + frac * (math.log(hi) - math.log(lo))
                    )
            # clamp to the observed range: small-count quantiles stay
            # honest (one sample reports itself, not a bucket midpoint)
            return min(max(est, lo_clamp), self.max)
        return self.max  # unreachable with count > 0; defensive

    # -- snapshots --------------------------------------------------------

    def summary(self) -> dict:
        """Quantile summary without buckets (the ``status`` form)."""
        out = {
            "count": self.count,
            "sum_s": round(self.sum, 6),
            "min_s": round(self.min, 6) if math.isfinite(self.min) else None,
            "max_s": round(self.max, 6),
        }
        for q in _QUANTILES:
            v = self.quantile(q)
            out[f"p{int(q * 100)}_s"] = None if v is None else round(v, 6)
        return out

    def snapshot(self) -> dict:
        """Summary + sparse buckets (the mergeable run-report form)."""
        out = self.summary()
        out["buckets"] = {
            str(i): c for i, c in enumerate(self.counts) if c
        }
        return out

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        """Rebuild a mergeable histogram from a :meth:`snapshot` dict
        (tolerates summaries without buckets by reconstructing nothing)."""
        h = cls()
        for k, c in (snap.get("buckets") or {}).items():
            i = int(k)
            if 0 <= i < N_BUCKETS:
                h.counts[i] = int(c)
        h.count = int(snap.get("count", sum(h.counts)))
        h.sum = float(snap.get("sum_s", 0.0))
        h.max = float(snap.get("max_s", 0.0))
        mn = snap.get("min_s")
        h.min = math.inf if mn is None else float(mn)
        return h
