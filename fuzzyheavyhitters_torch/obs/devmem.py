"""Device-memory and kernel-build telemetry (the port of
``fuzzyheavyhitters_tpu/obs/devmem.py``: the same gauge and counter names).

- :func:`sample` reads the card's allocator (``torch.cuda.memory_stats``:
  ``allocated_bytes.all.current`` and the allocator's own peak,
  ``allocated_bytes.all.peak``) and its capacity
  (``torch.cuda.mem_get_info``) and sets ``hbm_in_use_bytes`` /
  ``hbm_watermark_bytes`` / ``hbm_delta_bytes`` / ``hbm_limit_bytes`` on a
  registry.  The watermark is the allocator's peak, so a sample taken at a
  level's end still sees the level's high water; nothing here resets that
  peak (the benchmark reads ``max_memory_allocated`` over its window).  A
  ``phase`` argument adds a per-phase watermark of the bytes in use at
  the phase's samples (``hbm_watermark_bytes:<phase>``).  On the CPU (no
  card, or a process that never touched it) the in-use bytes are 0 and the
  capacity unknown: the port keeps no walk over live tensors, so nothing
  here costs more than one allocator query.
- :func:`tree_nbytes` sizes the tensors (and numpy arrays) of a nested
  structure; the session layer publishes ``key_plane_bytes`` with it when
  a collection's key plane is concatenated.
- The compile counter: the port compiles no XLA, so its fresh compile is
  an ``nvcc`` build of a kernel library (``ops/cuda_build.build``; a
  cached library's load is no compile).  :func:`note_fresh_compile`
  counts it as ``fresh_compiles`` and ``fresh_compiles:<span>`` (the
  innermost active span of any live registry, ``unknown`` outside one)
  on the default registry, with its seconds under the ``nvcc_compile``
  timer; after :func:`note_warmup_done` it also counts
  ``fresh_compiles_post_warmup``, as the JAX listener counts an XLA
  compile past the warmup ladder.

``torch`` is imported inside each function.
"""

from __future__ import annotations

import threading

from . import logs
from .metrics import Registry, all_registries, default_registry

_lock = threading.Lock()
# fhh-guard: _state=_lock
_state = {"warmup_done": False}


def device_bytes() -> tuple[int, int | None]:
    """(bytes the caching allocator holds for tensors now, the card's
    capacity or None) of the current card; (0, None) without one."""
    in_use, _peak, total = _allocator()
    return in_use, total


def _allocator() -> tuple[int, int, int | None]:
    """(bytes in use now, the allocator's peak of them, the card's
    capacity or None) of the current card; (0, 0, None) without one."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return 0, 0, None
    stats = torch.cuda.memory_stats()
    _free, total = torch.cuda.mem_get_info()
    return (int(stats.get("allocated_bytes.all.current", 0)),
            int(stats.get("allocated_bytes.all.peak", 0)), int(total))


def tree_nbytes(tree) -> int:
    """Total bytes of the tensor and array leaves of a nested structure
    (tuples, lists, dicts, named tuples); 0 for None."""
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    nb = getattr(tree, "nbytes", None)
    if nb is not None:
        return int(nb)
    numel = getattr(tree, "numel", None)
    if numel is not None and hasattr(tree, "element_size"):
        return int(numel()) * int(tree.element_size())
    return 0


def sample(reg: Registry | None = None, phase: str | None = None) -> int:
    """One memory sample onto ``reg`` (default registry when None):
    sets the in-use gauge, advances the watermark to the allocator's
    peak, records the delta since the previous sample, and (with
    ``phase``) a per-phase watermark.  Returns bytes in use."""
    reg = reg if reg is not None else default_registry()
    in_use, peak, limit = _allocator()
    prev = reg.gauge_value("hbm_in_use_bytes") or 0
    reg.gauge("hbm_in_use_bytes", in_use)
    reg.gauge("hbm_delta_bytes", in_use - prev)
    wm = reg.gauge_value("hbm_watermark_bytes") or 0
    if max(in_use, peak) > wm:
        reg.gauge("hbm_watermark_bytes", max(in_use, peak))
    if limit:
        reg.gauge("hbm_limit_bytes", limit)
    if phase:
        key = f"hbm_watermark_bytes:{phase}"
        if in_use > (reg.gauge_value(key) or 0):
            reg.gauge(key, in_use)
    return in_use


# -- fresh-compile accounting ---------------------------------------------


def _span_name() -> str:
    """The innermost active span name across every live registry — the
    phase a compile is attributed to (``unknown`` outside any span)."""
    for reg in all_registries():
        sp = reg.current_span()
        if sp is not None:
            return sp.name
    return "unknown"


def note_fresh_compile(program: str, seconds: float) -> None:
    """Count one fresh kernel build (``program``: the library's name)."""
    reg = default_registry()
    name = _span_name()
    reg.count("fresh_compiles")
    reg.count(f"fresh_compiles:{name}")
    reg.timer_add("nvcc_compile", seconds)
    with _lock:
        warm = _state["warmup_done"]
    if warm:
        reg.count("fresh_compiles_post_warmup")
        logs.emit(
            "compile.post_warmup", severity="debug",
            program=program, span=name, seconds=round(seconds, 4),
        )


def note_warmup_done() -> None:
    """Mark the warmup ladder complete: every fresh compile after this
    is a ``fresh_compiles_post_warmup`` event."""
    with _lock:
        _state["warmup_done"] = True


def _reset_for_tests() -> None:
    with _lock:
        _state["warmup_done"] = False
