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

Some functions of that package import a sibling module at call time
(``from ..ops import gc_pallas``).  Call them inside :func:`installed`,
which puts the modules :func:`reference` loaded back for the length of the
block, so such an import finds the module already loaded.

:func:`pallas_eager` runs that package's Pallas kernels without compiling
them: XLA:CPU takes minutes and tens of GB to compile even the smallest
secure kernel in interpret mode.  Inside it each ``pl.pallas_call`` walks
its grid in Python and calls the kernel body once per grid step, op by op,
on numpy views of the blocks its ``BlockSpec`` index maps select; output
blocks are views of the output, so a body that accumulates into a block
over several steps does so as on the chip.
"""

import contextlib
import importlib
import importlib.util
import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax._src.interpreters import batching as _batching
from jax.experimental import pallas as _pl

_PKG = "fuzzyheavyhitters_tpu"
_loaded: dict = {}  # every module of the package that reference() loaded


@contextlib.contextmanager
def _shimmed():
    proxy = type(_batching.primitive_batchers)
    shim = not hasattr(proxy, "__contains__") and hasattr(
        _batching, "fancy_primitive_batchers")
    if shim:
        proxy.__contains__ = (
            lambda self, prim: prim in _batching.fancy_primitive_batchers)
    try:
        yield
    finally:
        if shim:
            del proxy.__contains__


def _remove(names):
    for name in sorted(names, key=len, reverse=True):
        mod = sys.modules.pop(name)
        parent, _, leaf = name.rpartition(".")
        if parent in sys.modules and getattr(sys.modules[parent], leaf, None) is mod:
            delattr(sys.modules[parent], leaf)


def _ours(names):
    return [m for m in names if m == _PKG or m.startswith(_PKG + ".")]


def reference(*names):
    """Import the named modules of the JAX package; returns them in order."""
    before = set(sys.modules)
    with _shimmed():
        try:
            return [importlib.import_module(n) for n in names]
        finally:
            added = _ours(set(sys.modules) - before)
            _loaded.update({m: sys.modules[m] for m in added})
            _remove(added)


def reference_file(path, name):
    """Import a file that imports the JAX package (one of its test
    modules) as module ``name``, as :func:`reference` imports a module."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    before = set(sys.modules)
    with _shimmed():
        try:
            spec.loader.exec_module(mod)
        finally:
            added = _ours(set(sys.modules) - before)
            _loaded.update({m: sys.modules[m] for m in added})
            _remove(added)
    return mod


@contextlib.contextmanager
def installed():
    """The modules :func:`reference` loaded, back in ``sys.modules`` (with
    the batching shim) for the length of the block, then removed again."""
    before = set(sys.modules)
    with _shimmed():
        put = [m for m in _loaded if m not in sys.modules]
        for name in sorted(put, key=len):
            sys.modules[name] = _loaded[name]
            parent, _, leaf = name.rpartition(".")
            if parent in sys.modules:
                setattr(sys.modules[parent], leaf, _loaded[name])
        try:
            yield
        finally:
            added = _ours(set(sys.modules) - before)
            _loaded.update({m: sys.modules[m] for m in added})
            _remove(added)


@contextlib.contextmanager
def attached(package, **submodules):
    """``package``'s submodule attributes set for the length of the block
    (inside :func:`installed`): the loader detaches them after each import,
    and code that reaches a submodule through its package (``obs.trace``)
    needs the one its own load imported."""
    saved = {k: getattr(package, k, None) for k in submodules}
    for k, mod in submodules.items():
        setattr(package, k, mod)
    try:
        yield
    finally:
        for k, old in saved.items():
            if old is not None:
                setattr(package, k, old)
            elif hasattr(package, k):
                delattr(package, k)


class _Ref:
    """A kernel ref over a numpy block view: reads give jax arrays, writes
    land in the view."""

    def __init__(self, block):
        self.block = block

    def __getitem__(self, i):
        return jnp.asarray(self.block[i])

    def __setitem__(self, i, v):
        self.block[i] = np.asarray(v)


def _block(a, spec, step):
    """The view of ``a`` that ``spec`` maps grid step ``step`` to."""
    idx = spec.index_map(*step)
    return a[tuple(slice(int(i) * b, (int(i) + 1) * b)
                   for i, b in zip(idx, spec.block_shape))]


def _eager_pallas_call(kernel, *, grid, in_specs, out_specs, out_shape, **_):
    def call(*args):
        ins = [np.asarray(a) for a in args]
        outs = [np.zeros(s.shape, s.dtype) for s in out_shape]
        for step in itertools.product(*(range(g) for g in grid)):
            _pl.program_id = lambda axis: jnp.int32(step[axis])
            kernel(*[_Ref(_block(a, s, step)) for a, s in zip(ins, in_specs)],
                   *[_Ref(_block(o, s, step)) for o, s in zip(outs, out_specs)])
        return [jnp.asarray(o) for o in outs]
    return call


@contextlib.contextmanager
def pallas_eager():
    """Run the JAX package's Pallas kernels on the grid walk above (and
    its jitted wrappers op by op) for the length of the block."""
    saved = _pl.pallas_call, _pl.program_id, _pl.when
    _pl.pallas_call = _eager_pallas_call
    _pl.when = lambda cond: (lambda body: body() if bool(cond) else None)
    try:
        with jax.disable_jit():
            yield
    finally:
        _pl.pallas_call, _pl.program_id, _pl.when = saved
