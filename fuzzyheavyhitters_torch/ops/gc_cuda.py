"""Garbled-circuit equality: CUDA kernels (``csrc/gc.cu``) and their plain
versions.

Replaces ``fuzzyheavyhitters_tpu/ops/gc_pallas.py:_garble_call`` and
``:_eval_call``.  Both versions share one plane-major interface over bp
tests (plane p of test t at ``[p, t]``, int32 words):

    garble_planar(R 4 uint32 values, X0 [4S, bp], Y0 [4S, bp], xb [S, bp],
                  mask [1, bp], mv0/mv1 [W, bp], idx0)
        -> (tables [8(S-1), bp], gb_labels [4S, bp], decode [1, bp], cts [2W, bp])
    eval_planar(gbl [4S, bp], evl [4S, bp], tables, decode, cts, idx0)
        -> (e [1, bp], pay [W, bp])

Test t's pad index is ``idx0 + t`` mod 2^32.  The plain versions are
``gc.garble_planar_plain`` / ``gc.eval_planar_plain``.  The wrappers launch
the kernel for CUDA tensors and run the plain version for CPU tensors;
there is no fallback from one to the other.  ``GARBLE_LAUNCHES`` and
``EVAL_LAUNCHES`` count kernel launches.

The kernels walk the AND tree in a rolled loop over :func:`gate_schedule`,
which is built here and handed to them as one int32 word a gate.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build, gc, prg

GARBLE_LAUNCHES = 0
EVAL_LAUNCHES = 0
# string widths csrc/gc.cu takes: S is a kernel argument up to its
# FHH_GC_MAX_S (the schedule's shared array); W is a template parameter
KERNEL_S = tuple(range(2, 17))
KERNEL_W = (4, 8)

_lock = threading.Lock()
_schedules: dict = {}  # fhh-guard: _schedules=_lock


def gate_schedule(S: int) -> np.ndarray:
    """The AND tree of ``gc._and_tree_garble`` as the kernels walk it:
    uint8[S-1, 5], row g = gate g's (a, b, o, a_leaf, b_leaf).  Layer by
    layer the live wires pair up, (0, 1), (2, 3), ..., and the next layer's
    wires are the gate outputs in order, then any leftover wire.  An input
    is a leaf (flag 1: input wire ``a`` or ``b``, read from the label
    planes) or an earlier gate's output (flag 0: output slot ``a`` or
    ``b``).  A gate reads its inputs, which frees their slots, then writes
    output slot ``o``, the lowest free one: S // 2 slots serve every
    width, and the last gate's output is the circuit's."""
    live = [(s, 1) for s in range(S)]  # (wire or slot, is a leaf)
    free, rows = list(range(S // 2)), []
    while len(live) > 1:
        k, nxt = len(live) // 2, []
        for i in range(k):
            (a, la), (b, lb) = live[2 * i], live[2 * i + 1]
            free += [x for x, leaf in ((a, la), (b, lb)) if not leaf]
            free.sort()
            o = free.pop(0)
            rows.append((a, b, o, la, lb))
            nxt.append((o, 0))
        live = nxt + live[2 * k:]
    return np.array(rows, np.uint8).reshape(S - 1, 5)


def _schedule(S: int, dev) -> torch.Tensor:
    """:func:`gate_schedule` on ``dev`` as the kernels read it: one int32
    word a gate, a | b << 8 | o << 16 | a_leaf << 24 | b_leaf << 25 (cached
    per device and S)."""
    key = (str(dev), S)
    with _lock:
        words = _schedules.get(key)
        if words is None:
            g = gate_schedule(S).astype(np.int32)
            words = torch.from_numpy(g[:, 0] | g[:, 1] << 8 | g[:, 2] << 16 | g[:, 3] << 24
                                     | g[:, 4] << 25).to(dev)
            _schedules[key] = words
    return words


def _lib():
    lib = cuda_build.load("gc")
    if lib.fhh_gc_garble_launch.argtypes is None:
        vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.fhh_gc_garble_launch.argtypes = [vp] * 11 + [ll, i, i, u, u, u, u, u, vp]
        lib.fhh_gc_garble_launch.restype = i
        lib.fhh_gc_eval_launch.argtypes = [vp] * 8 + [ll, i, i, u, vp]
        lib.fhh_gc_eval_launch.restype = i
    return lib


def garble_planar(R, X0, Y0, xb, mask, mv0, mv1, idx0: int):
    """Garble bp tests: the kernel on a CUDA device, the plain version on
    the CPU.  ``R`` is 4 uint32 values (lsb(R) = 1)."""
    global GARBLE_LAUNCHES
    S, n, W = xb.shape[0], X0.shape[1], mv0.shape[0]
    dev = cuda_build.check_planes(
        "garble", [("X0", X0, 4 * S), ("Y0", Y0, 4 * S), ("xb", xb, S), ("mask", mask, 1),
                   ("mv0", mv0, W), ("mv1", mv1, W)], n)
    R = [int(r) & prg.M32 for r in R]
    if len(R) != 4 or not R[0] & 1:
        raise ValueError("garble: R must be 4 words with lsb(R) = 1")
    if dev.type == "cpu":
        return gc.garble_planar_plain(R, X0, Y0, xb, mask, mv0, mv1, idx0)
    cuda_build.check_compiled("gc.cu", S, W, KERNEL_S, KERNEL_W)
    X0, Y0, xb, mask, mv0, mv1 = (a.contiguous() for a in (X0, Y0, xb, mask, mv0, mv1))
    out = [torch.empty((k, n), dtype=torch.int32, device=dev)
           for k in (8 * (S - 1), 4 * S, 1, 2 * W)]
    lib = _lib()
    rc = lib.fhh_gc_garble_launch(
        X0.data_ptr(), Y0.data_ptr(), xb.data_ptr(), mask.data_ptr(), mv0.data_ptr(),
        mv1.data_ptr(), _schedule(S, dev).data_ptr(), *(o.data_ptr() for o in out), n, S, W,
        *R, idx0 & prg.M32, cuda_build.stream_ptr(X0))
    cuda_build.check(lib, rc, "garble")
    GARBLE_LAUNCHES += 1
    return tuple(out)


def eval_planar(gbl, evl, tab, dec, cts, idx0: int):
    """Evaluate bp tests: the kernel on a CUDA device, the plain version on
    the CPU."""
    global EVAL_LAUNCHES
    S, n, W = gbl.shape[0] // 4, gbl.shape[1], cts.shape[0] // 2
    dev = cuda_build.check_planes(
        "eval", [("gbl", gbl, 4 * S), ("evl", evl, 4 * S), ("tables", tab, 8 * (S - 1)),
                 ("decode", dec, 1), ("cts", cts, 2 * W)], n)
    if dev.type == "cpu":
        return gc.eval_planar_plain(gbl, evl, tab, dec, cts, idx0)
    cuda_build.check_compiled("gc.cu", S, W, KERNEL_S, KERNEL_W)
    gbl, evl, tab, dec, cts = (a.contiguous() for a in (gbl, evl, tab, dec, cts))
    e = torch.empty((1, n), dtype=torch.int32, device=dev)
    pay = torch.empty((W, n), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.fhh_gc_eval_launch(gbl.data_ptr(), evl.data_ptr(), tab.data_ptr(), dec.data_ptr(),
                                cts.data_ptr(), _schedule(S, dev).data_ptr(), e.data_ptr(),
                                pay.data_ptr(), n, S, W, idx0 & prg.M32,
                                cuda_build.stream_ptr(gbl))
    cuda_build.check(lib, rc, "eval")
    EVAL_LAUNCHES += 1
    return e, pay
