"""Runtime shadow-taint sanitizer (the port of
``fuzzyheavyhitters_tpu/utils/taint_guard.py``: the same switch, API,
source labels and sink names).

Under ``FHH_DEBUG_TAINT=1`` the constructors of the protocol's secrets
:func:`register` their buffers' bytes, and every obs sink boundary (log
emit, metrics render, trace record, alert fire, report build) runs
:func:`check` over its rendered payload: no registered buffer may cross,
byte-equal, byte-contained, or interpolated as its hex or ``str`` text.
The end-to-end and chaos tests then exercise the assertion on every
scrape, trace and recovery path they already cover.

Off by default and free when off: with the variable unset :func:`register`
returns before touching its value and :func:`check` is one module-global
bool test.

The port holds its secrets as ``torch.Tensor`` (int32 bit patterns of the
uint32 words) as well as numpy arrays.  A tensor has no ``tobytes``, so it
is copied to the host once (``.detach().contiguous().cpu().numpy()``) and
its bytes are registered, or scanned, in the dtype and layout the port
holds them in.  A tensor on the card met inside an obs payload costs a
device sync: acceptable only because the sanitizer is off unless asked for.

A buffer under 8 bytes gets byte markers but no hex marker, where the JAX
twin gives every buffer one: the hex of an imported pool's one-key leaves
(a key index, two control bits) matches the digits of any port number or
byte count in a log line.

Sanctioned flows run inside :func:`declassified`, whose ``reason`` is
required.  :data:`_DEFAULT_SOURCES` names the sources the port registers,
the same labels as the JAX package's table.  The window and sketch roots
are absent on purpose: they are one-way commitments that seal stats and
checkpoints carry by design (``sketch.window_root``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os

__all__ = [
    "TaintViolation",
    "check",
    "declassified",
    "enabled",
    "marker_count",
    "register",
    "reset",
]

_ENV = "FHH_DEBUG_TAINT"

# source label -> the port's site that registers it (the JAX table's keys)
_DEFAULT_SOURCES = {
    "CollectionSession._sec_seed": "protocol/sessions.py reset_state + rpc._setup_secure",
    "CollectionSession._sketch_seed": "rpc._ensure_session_plane coin flip",
    "CollectionSession._ratchet_digest": "sketch.transcript_absorb",
    "OtExtSender._seeds": "ops/otext.py OtExtSender.__init__",
    "OtExtSender.s_bits": "ops/otext.py OtExtSender.__init__",
    "OtExtReceiver._seeds0": "ops/otext.py OtExtReceiver.__init__",
    "OtExtReceiver._seeds1": "ops/otext.py OtExtReceiver.__init__",
    "CollectionSession._imported_pool_shares": "rpc session_import pool reconstruction",
}

# True once any source registered in this process: check() is one bool
# test until then
_armed = False

# byte images of the registered buffers, and the text forms an f-string
# interpolation would render them as
_byte_markers: dict[bytes, str] = {}
_text_markers: dict[str, str] = {}

# depth of declassified windows of the current task (a contextvar: one
# task's window never blesses a neighbour's render)
_declass_depth: contextvars.ContextVar[int] = contextvars.ContextVar(
    "fhh_torch_declass_depth", default=0)

# a shorter text marker (a small scalar's repr) would trip on unrelated
# digits in any rendered line
_MIN_TEXT_MARKER = 8
# nor is the hex of a buffer under 8 bytes a marker: an imported pool's
# one-key leaves (a key index, two control bits) would match the digits of
# a port number or a byte count; their bytes stay byte markers
_MIN_HEX_MARKER = 16


class TaintViolation(AssertionError):
    """A registered secret buffer (or its rendered text) crossed an obs sink
    boundary."""


def enabled() -> bool:
    """True when ``FHH_DEBUG_TAINT=1``; read per registration (sources are
    built at handshakes and OT set-ups, never on a hot path)."""
    return os.environ.get(_ENV, "") == "1"


_NOOP = contextlib.nullcontext()


class _DeclassifiedWindow:
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _declass_depth.set(_declass_depth.get() + 1)
        return None

    def __exit__(self, *exc):
        _declass_depth.reset(self._token)
        return False


def declassified(reason: str):
    """Suspend the assertions for the current task while the body runs.
    ``reason`` is mandatory and non-empty."""
    if not reason or not reason.strip():
        raise ValueError("declassified() requires a written reason")
    if not _armed:
        return _NOOP
    return _DeclassifiedWindow()


def _is_tensor(value) -> bool:
    return callable(getattr(value, "detach", None)) and callable(getattr(value, "cpu", None))


def _host(value):
    """A tensor's host numpy copy (one device sync for a card tensor); any
    other value as it is."""
    if _is_tensor(value):
        return value.detach().contiguous().cpu().numpy()
    return value


def _buffer_bytes(value) -> bytes | None:
    if isinstance(value, (bytes, bytearray, memoryview)):
        return bytes(value)
    try:
        value = _host(value)
        tobytes = getattr(value, "tobytes", None)
        return tobytes() if callable(tobytes) else None
    # fhh-lint: disable=broad-except (a sanitizer must never crash
    # the protocol it watches: an exotic tobytes() is just skipped)
    except Exception:
        return None


def register(label: str, value) -> None:
    """Register one secret buffer: a numpy array, a tensor (on either
    device) or bytes.  Free when the sanitizer is off; never raises."""
    global _armed
    if not enabled() or value is None:
        return
    raw = _buffer_bytes(value)
    if raw is None or len(raw) == 0:
        return
    _armed = True
    _byte_markers[raw] = label
    if 2 * len(raw) >= _MIN_HEX_MARKER:
        _text_markers.setdefault(raw.hex(), label)
    try:  # the interpolated form: str(ndarray) / str(bytes)
        text = str(_host(value)).strip()
    # fhh-lint: disable=broad-except (sanitizer-never-crashes: a value
    # whose __str__ throws simply gets no text marker)
    except Exception:
        return
    if len(text) >= _MIN_TEXT_MARKER:
        _text_markers.setdefault(text, label)


def marker_count() -> int:
    """How many buffers are registered (a run's figure of what was watched)."""
    return len(_byte_markers)


def reset() -> None:
    """Drop every marker and disarm (test isolation)."""
    global _armed
    _armed = False
    _byte_markers.clear()
    _text_markers.clear()


def _scan_text(text: str, sink: str) -> None:
    # a snapshot: a scrape thread scans while the event loop registers
    for marker, label in tuple(_text_markers.items()):
        if marker in text:
            # fhh-lint: disable=secret-to-sink (`label` here is the
            # SOURCE NAME from the registry — "CollectionSession
            # ._sec_seed" — never the secret bytes themselves)
            raise TaintViolation(
                f"rendered text at sink '{sink}' contains the interpolated bytes of "
                f"registered source '{label}': key material crossed an obs boundary "
                "(mask or open it first, or wrap a sanctioned flow in "
                "taint_guard.declassified(reason))")


def _scan_bytes(raw: bytes, sink: str) -> None:
    for marker, label in tuple(_byte_markers.items()):
        if marker == raw or (len(raw) > len(marker) and marker in raw):
            # fhh-lint: disable=secret-to-sink (`label` is the source
            # NAME from the registry, never the secret bytes)
            raise TaintViolation(
                f"payload at sink '{sink}' carries the raw bytes of registered source "
                f"'{label}': key material crossed an obs boundary")


def _scan(obj, sink: str, depth: int) -> None:
    if depth > 6 or obj is None or isinstance(obj, (bool, int, float)):
        return
    if isinstance(obj, str):
        _scan_text(obj, sink)
        return
    if isinstance(obj, (bytes, bytearray, memoryview)):
        _scan_bytes(bytes(obj), sink)
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            _scan(k, sink, depth + 1)
            _scan(v, sink, depth + 1)
        return
    if isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _scan(v, sink, depth + 1)
        return
    raw = _buffer_bytes(obj)
    if raw is not None:
        _scan_bytes(raw, sink)
        return
    # anything else reaches the sink through str(): scan that form
    try:
        _scan_text(str(obj), sink)
    except TaintViolation:
        raise
    # fhh-lint: disable=broad-except (sanitizer-never-crashes: objects
    # whose __str__ throws are not scannable and not sink-renderable)
    except Exception:
        pass


def check(obj, *, sink: str) -> None:
    """Assert no registered buffer is reachable from ``obj``: byte-equal,
    byte-contained or rendered as text.  One bool test when off."""
    if not _armed or _declass_depth.get():
        return
    _scan(obj, sink, 0)
