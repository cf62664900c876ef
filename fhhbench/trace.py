"""What a traced run (``--trace 1``) reads, and the reductions the
per-layer readers share.

- :class:`KernelTap` wraps the program's six kernel wrappers, named by the
  files of ``roofline/``, and records each call's work while armed.
- :func:`profile_collection` runs one collection under ``torch.profiler``
  and keeps its device and host intervals.
- :class:`Trace` is what every ``metrics/<name>.py`` reader gets.
"""

from __future__ import annotations

import contextlib
import functools
import heapq
import importlib
from dataclasses import dataclass, field

from fhhbench import roofline

SPAN = "fhhbench.collection"  # the profiled collection's host range
STEP = "fhhbench."  # the prefix of the collection's step ranges (collection.py)


@dataclass
class Trace:
    """The profiled collection of a traced run: its intervals (ns, on the
    profiler's clock) and the kernel calls recorded in it."""

    span: tuple = (0, 0)  # the profiled collection, start and end
    kernels: list = field(default_factory=list)  # (name, start, end) device kernels
    copies: list = field(default_factory=list)  # (name, start, end) memcpy / memset
    host: list = field(default_factory=list)  # (name, start, end) host ops and runtime calls
    calls: dict = field(default_factory=dict)  # kernel -> [(bytes, ops)] in the profiled collection
    kernel_names: dict = field(default_factory=dict)  # kernel -> device name substring

    @property
    def span_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def busy(self) -> list:
        """Merged device-busy intervals (kernels and copies) inside the span."""
        lo, hi = self.span
        iv = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels + self.copies
                    if e > lo and s < hi)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of one of the port's kernels in the span."""
        sub = self.kernel_names[kernel]
        return sum(e - s for n, s, e in self.kernels if sub in n) / 1e9

    def launches(self, kernel: str) -> int:
        sub = self.kernel_names[kernel]
        return sum(1 for n, _, _ in self.kernels if sub in n)

    def roofline_pct(self, kernel: str):
        """100 x the least time of the recorded calls' work over their device
        time; None where the kernel did not run, or where its device
        launches and the recorded calls disagree."""
        calls = self.calls.get(kernel, [])
        if not calls or self.launches(kernel) != len(calls):
            return None
        return 100.0 * sum(roofline.bound_s(b, o) for b, o in calls) / self.kernel_s(kernel)

    def breakdown(self) -> dict:
        """The ten device ops that took most time, and the ten host ops
        (innermost at a gap's middle) that the longest idle time fell in."""
        ops = {}
        for n, s, e in self.kernels + self.copies:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        busy = self.busy()
        edges = [self.span[0]] + [x for iv in busy for x in iv] + [self.span[1]]
        gaps = {}
        host = sorted(self.host, key=lambda h: h[1])
        open_ops, nxt = [], 0  # a max-heap by start of the host ops begun so far
        for s, e in zip(edges[::2], edges[1::2]):  # gaps in time order
            if e <= s:
                continue
            mid = (s + e) // 2
            while nxt < len(host) and host[nxt][1] <= mid:
                heapq.heappush(open_ops, (-host[nxt][1], host[nxt][2], host[nxt][0]))
                nxt += 1
            while open_ops and open_ops[0][1] <= mid:  # ended before this gap: for good
                heapq.heappop(open_ops)
            name = open_ops[0][2] if open_ops else "(no host op)"  # the innermost: latest begun
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e9
        top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


class KernelTap:
    """Records each call of the kernels' wrappers while armed: per kernel
    the (bytes, ops) its ``roofline/<kernel>.py`` reckons from the call."""

    def __init__(self, kernels: dict):
        self.kernels = kernels  # name -> the roofline module
        self.calls = {k: [] for k in kernels}
        self.armed = False
        self._saved = []

    def install(self):
        for name, mod in self.kernels.items():
            owner = importlib.import_module(mod.WRAPPER[0])
            fn = getattr(owner, mod.WRAPPER[1])
            self._saved.append((owner, mod.WRAPPER[1], fn))
            setattr(owner, mod.WRAPPER[1], self._wrap(name, mod, fn))

    def _wrap(self, name, mod, fn):
        @functools.wraps(fn)
        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed:
                self.calls[name].append(mod.work(args, kwargs, out))
            return out
        return tapped

    def uninstall(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


@contextlib.contextmanager
def profile_collection(trace: Trace, tap: KernelTap, dev):
    """Profile the body (one whole collection on ``dev``) into ``trace``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda_dev = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda_dev else [])
    tap.armed = True
    try:
        with profile(activities=activities) as prof:
            with record_function(SPAN):
                yield
            if cuda_dev:
                torch.cuda.synchronize(dev)
    finally:
        tap.armed = False
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.name() == SPAN:
            if e.device_type() != cuda:
                trace.span = iv[1:]
        elif e.device_type() != cuda:
            trace.host.append(iv)
        elif not (e.is_user_annotation() or e.name().startswith(STEP)):
            # the device's mirror of a host range is no device work
            (trace.copies if e.name().startswith(("Memcpy", "Memset")) else trace.kernels).append(iv)
    trace.calls = {k: list(v) for k, v in tap.calls.items()}
    trace.kernel_names = {k: m.KERNEL for k, m in tap.kernels.items()}
