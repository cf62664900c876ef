"""Shared set-up of the PyTorch port's parity tests (``test_torch_*.py``):
loading the JAX package, the port's reference.

That package's ``ops/prg.py`` asks ``x in jax.interpreters.batching.
primitive_batchers`` while it registers a batching rule; on JAX releases
where that table is a write-only proxy, the question raises ``TypeError``
and nothing under ``ops/`` imports.  :func:`reference` answers it from the
table the proxy writes to for the length of one import, and then puts the
interpreter back as it found it: the shim is removed and the package's
newly imported modules leave ``sys.modules`` (and their parents'
attributes), so every other test module imports the JAX package exactly as
it would without these tests.  The callers keep the module objects they
were handed.  No code of either package changes.
"""

import importlib
import sys

from jax._src.interpreters import batching as _batching

_PKG = "fuzzyheavyhitters_tpu"


def reference(*names):
    """Import the named modules of the JAX package; returns them in order."""
    before = set(sys.modules)
    proxy = type(_batching.primitive_batchers)
    shim = not hasattr(proxy, "__contains__") and hasattr(
        _batching, "fancy_primitive_batchers")
    if shim:
        proxy.__contains__ = (
            lambda self, prim: prim in _batching.fancy_primitive_batchers)
    try:
        return [importlib.import_module(n) for n in names]
    finally:
        if shim:
            del proxy.__contains__
        added = [m for m in set(sys.modules) - before
                 if m == _PKG or m.startswith(_PKG + ".")]
        for name in sorted(added, key=len, reverse=True):
            mod = sys.modules.pop(name)
            parent, _, leaf = name.rpartition(".")
            if parent in sys.modules and getattr(sys.modules[parent], leaf, None) is mod:
                delattr(sys.modules[parent], leaf)
