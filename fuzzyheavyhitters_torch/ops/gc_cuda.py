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
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, gc, prg

GARBLE_LAUNCHES = 0
EVAL_LAUNCHES = 0
KERNEL_S = tuple(range(2, 17, 2))  # string widths csrc/gc.cu is compiled for
KERNEL_W = (4, 8)


def _lib():
    lib = cuda_build.load("gc")
    if lib.fhh_gc_garble_launch.argtypes is None:
        vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.fhh_gc_garble_launch.argtypes = [vp] * 10 + [ll, i, i, u, u, u, u, u, vp]
        lib.fhh_gc_garble_launch.restype = i
        lib.fhh_gc_eval_launch.argtypes = [vp] * 7 + [ll, i, i, u, vp]
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
        mv1.data_ptr(), *(o.data_ptr() for o in out), n, S, W, *R, idx0 & prg.M32,
        cuda_build.stream_ptr(X0))
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
                                cts.data_ptr(), e.data_ptr(), pay.data_ptr(), n, S, W,
                                idx0 & prg.M32, cuda_build.stream_ptr(gbl))
    cuda_build.check(lib, rc, "eval")
    EVAL_LAUNCHES += 1
    return e, pay
