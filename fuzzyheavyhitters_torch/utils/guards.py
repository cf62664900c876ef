"""Runtime lock-discipline sanitizer (the port of
``fuzzyheavyhitters_tpu/utils/guards.py``: the same switch, API and
semantics).

Each guarded attribute of a shared object belongs to one asyncio lock of
that object (a guard map: ``attr -> lock attribute``).  Under
``FHH_DEBUG_GUARDS=1``, or ``Config.debug_guards``, every access to a
guarded attribute asserts that its lock is held *by the current task*, so
the end-to-end and chaos tests exercise the locking of every verb, replay,
recovery and fault path they already cover.

Off by default and free when off: :func:`install` leaves the instance's
class, and so every attribute access, untouched.  Armed, it moves the
instance onto a subclass made for it whose :class:`GuardedState`
descriptors wrap each guarded attribute (``type(obj)`` is then that
subclass: code that needs the class it wrote compares with ``isinstance``),
and wraps the named locks' ``acquire``/``release`` to track the owning
task.

Deliberately unlocked windows (the event-loop-atomic ingest fast path, the
frame-arrival pre-expand, the scrape thread's read of the session rows) run
inside :func:`unguarded`, whose ``reason`` is required.  The window lives in
a contextvar: it does not carry across threads or tasks.

Scope: asyncio locks only; a threading lock admits no ownership hook.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import os

__all__ = [
    "GuardViolation",
    "GuardedState",
    "enabled",
    "install",
    "unguarded",
]

_ENV = "FHH_DEBUG_GUARDS"

# True once any instance armed in this process: unguarded() on the dispatch
# path is one bool test until then
_armed = False

# depth of unlocked windows of the current task or thread
_unguarded_depth: contextvars.ContextVar[int] = contextvars.ContextVar(
    "fhh_torch_unguarded_depth", default=0)


class GuardViolation(AssertionError):
    """A guarded attribute was touched without its lock held by the current
    task."""


def enabled() -> bool:
    """True when ``FHH_DEBUG_GUARDS=1``; read per call (:func:`install` runs
    at construction, so a test that sets the variable first gets the mode it
    asked for)."""
    return os.environ.get(_ENV, "") == "1"


_NOOP = contextlib.nullcontext()


class _UnguardedWindow:
    __slots__ = ("_token",)

    def __enter__(self):
        self._token = _unguarded_depth.set(_unguarded_depth.get() + 1)
        return None

    def __exit__(self, *exc):
        _unguarded_depth.reset(self._token)
        return False


def unguarded(reason: str):
    """Suspend the assertions for the current task while the body runs.
    ``reason`` is mandatory and non-empty."""
    if not reason or not reason.strip():
        raise ValueError("unguarded() requires a written reason")
    if not _armed:
        return _NOOP
    return _UnguardedWindow()


def _current_task():
    try:
        return asyncio.current_task()
    except RuntimeError:  # no running loop: a sync caller or another thread
        return None


def _track_ownership(lock) -> None:
    """Wrap ``lock.acquire``/``release`` (once) so the lock remembers the
    task holding it; ``async with`` reaches them through the instance."""
    if getattr(lock, "_fhh_tracked", False):
        return
    orig_acquire, orig_release = lock.acquire, lock.release

    async def acquire(*a, **kw):
        ok = await orig_acquire(*a, **kw)
        lock._fhh_owner = _current_task()
        return ok

    def release(*a, **kw):
        lock._fhh_owner = None
        return orig_release(*a, **kw)

    lock.acquire = acquire
    lock.release = release
    lock._fhh_owner = None
    lock._fhh_tracked = True


class GuardedState:
    """A descriptor asserting lock ownership on every get, set and delete of
    one guarded attribute.  The value lives in the instance ``__dict__``
    under a shadow key, so installing keeps the state already built."""

    __slots__ = ("name", "lock_name", "_shadow")

    def __init__(self, name: str, lock_name: str):
        self.name = name
        self.lock_name = lock_name
        self._shadow = f"_fhh_guarded__{name}"

    def _check(self, obj) -> None:
        if _unguarded_depth.get():
            return
        lock = obj.__dict__.get(self.lock_name)
        if lock is None:
            lock = getattr(obj, self.lock_name, None)
        if lock is None:
            return  # the lock is not built yet: construction
        if not lock.locked():
            raise GuardViolation(
                f"guarded attribute '{type(obj).__name__}.{self.name}' accessed with its "
                f"owning lock '{self.lock_name}' not held (hold the lock or open a "
                "guards.unguarded(reason) window)")
        owner = getattr(lock, "_fhh_owner", None)
        task = _current_task()
        if owner is not None and task is not None and owner is not task:
            raise GuardViolation(
                f"guarded attribute '{type(obj).__name__}.{self.name}' accessed while "
                f"'{self.lock_name}' is held by another task")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj)
        try:
            return obj.__dict__[self._shadow]
        except KeyError:
            raise AttributeError(self.name) from None

    def __set__(self, obj, value):
        self._check(obj)
        obj.__dict__[self._shadow] = value

    def __delete__(self, obj):
        self._check(obj)
        try:
            del obj.__dict__[self._shadow]
        except KeyError:
            raise AttributeError(self.name) from None


def install(obj, guard_map: dict, force: bool = False) -> bool:
    """Arm the sanitizer on one instance when :func:`enabled` (or ``force``,
    the ``Config.debug_guards`` knob): move ``obj`` onto a subclass carrying
    a :class:`GuardedState` per ``guard_map`` entry and track the owner of
    each named lock.  Call it at the end of construction, once the guarded
    attributes exist.  -> whether it armed (False: ``obj`` untouched)."""
    global _armed
    if (not enabled() and not force) or not guard_map:
        return False
    _armed = True
    cls = type(obj)
    if getattr(cls, "_fhh_guards_installed", False):
        return True
    descriptors = {attr: GuardedState(attr, lock_name)
                   for attr, lock_name in guard_map.items()}
    for attr, desc in descriptors.items():
        if attr in obj.__dict__:
            obj.__dict__[desc._shadow] = obj.__dict__.pop(attr)
    obj.__class__ = type(f"Guarded{cls.__name__}", (cls,),
                         {**descriptors, "_fhh_guards_installed": True})
    for lock_name in set(guard_map.values()):
        lock = getattr(obj, lock_name, None)
        if lock is not None:
            _track_ownership(lock)
    return True
