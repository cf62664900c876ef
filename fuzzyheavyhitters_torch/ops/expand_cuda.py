"""Frontier expansion: the CUDA kernel (``csrc/expand.cu``) and its plain
version.

Replaces ``fuzzyheavyhitters_tpu/ops/expand_pallas.py:expand_packed``.
Both versions share one plane-major interface over B = F * N rows (node
f, client n = b % N) and d2 = 2 * n_dims planes (dim, side):

    seed int32[4, d2, B], t bool[d2, B], y bool[d2, B]   (eval states)
    cws int32[4, d2, N], cwf uint8[d2, N]                (this level's cw:
                                                          bl|br<<1|yl<<2|yr<<3)
    -> packed int32[B]           share bit y^t of child dir of plane p at
                                 bit p*2 + dir (collect._bit_positions)
       oseeds int32[2, 4, d2, B] t-corrected child seeds, direction-major
       oflags uint8[d2, B]       child bl|br<<1|yl<<2|yr<<3, y accumulated

:func:`expand_packed` launches the kernel for CUDA tensors and runs
:func:`expand_packed_plain` for CPU tensors; there is no fallback from one
to the other.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, prg

LAUNCHES = 0


def expand_packed_plain(seed, t, y, cws, cwf, derived_bits: bool,
                        want_children: bool = True, row0: int = 0):
    """The level expansion in plain PyTorch.  ``row0`` is the global index
    of row 0, so a caller may expand a row slice of a larger frontier (the
    cw index of local row i is ``(row0 + i) % N``)."""
    d2, B = t.shape
    N = cwf.shape[-1]
    dev = t.device
    idx = (torch.arange(B, device=dev) + row0) % N
    packed = torch.zeros(B, dtype=torch.int64, device=dev)
    oseeds = oflags = None
    if want_children:
        oseeds = torch.empty((2, 4, d2, B), dtype=torch.int32, device=dev)
        oflags = torch.empty((d2, B), dtype=torch.uint8, device=dev)
    for p in range(d2):
        sl, sr, (tl, tr), (yl, yr) = prg.expand_words(
            [prg.to_u64(seed[w, p]) for w in range(4)], derived_bits)
        tp, yp = t[p], y[p]
        cf = cwf[p].index_select(0, idx)
        bl = tl ^ (tp & ((cf & 1) != 0))
        br = tr ^ (tp & ((cf & 2) != 0))
        ylc = yl ^ (tp & ((cf & 4) != 0)) ^ yp
        yrc = yr ^ (tp & ((cf & 8) != 0)) ^ yp
        if want_children:
            for w in range(4):
                cw = torch.where(tp, prg.to_u64(cws[w, p].index_select(0, idx)), 0)
                oseeds[0, w, p] = prg.to_i32(sl[w] ^ cw)
                oseeds[1, w, p] = prg.to_i32(sr[w] ^ cw)
            u8 = lambda v, s: v.to(torch.uint8) << s
            oflags[p] = u8(bl, 0) | u8(br, 1) | u8(ylc, 2) | u8(yrc, 3)
        packed |= ((bl ^ ylc).to(torch.int64) << (2 * p)) | (
            (br ^ yrc).to(torch.int64) << (2 * p + 1))
    return prg.to_i32(packed), oseeds, oflags


def _lib():
    lib = cuda_build.load("expand")
    if lib.fhh_expand_launch.argtypes is None:
        vp = ctypes.c_void_p
        lib.fhh_expand_launch.argtypes = [vp] * 8 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, vp]
        lib.fhh_expand_launch.restype = ctypes.c_int
    return lib


def _check(seed, t, y, cws, cwf):
    d2, B = t.shape
    N = cwf.shape[-1]
    for name, a, dtype, shape in (
        ("seed", seed, torch.int32, (4, d2, B)),
        ("t", t, torch.bool, (d2, B)),
        ("y", y, torch.bool, (d2, B)),
        ("cws", cws, torch.int32, (4, d2, N)),
        ("cwf", cwf, torch.uint8, (d2, N)),
    ):
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name}: want {dtype}{list(shape)}, got {a.dtype}{list(a.shape)}")
        if a.device != t.device:
            raise ValueError(f"{name} is on {a.device}, t on {t.device}")
    if N == 0 or B % N:
        raise ValueError(f"rows B={B} must be a whole number of client blocks N={N}")


def expand_packed(seed, t, y, cws, cwf, derived_bits: bool | None = None,
                  want_children: bool = True):
    """One level's expansion of B rows: the kernel on a CUDA device, the
    plain version on the CPU.  Returns ``(packed, oseeds, oflags)``; the
    last two are None when ``want_children`` is False (the last level)."""
    global LAUNCHES
    if derived_bits is None:
        derived_bits = prg.DERIVED_BITS
    _check(seed, t, y, cws, cwf)
    if t.device.type == "cpu":
        return expand_packed_plain(seed, t, y, cws, cwf, derived_bits, want_children)
    if t.device.type != "cuda":
        raise ValueError(f"expand runs on cuda or cpu, not {t.device}")
    if prg.N_ROUNDS != 8:
        raise ValueError("csrc/chacha.cuh is compiled for N_ROUNDS = 8")
    d2, B = t.shape
    N = cwf.shape[-1]
    seed, t, y, cws, cwf = (a.contiguous() for a in (seed, t, y, cws, cwf))
    dev = t.device
    packed = torch.empty(B, dtype=torch.int32, device=dev)
    oseeds = oflags = None
    if want_children:
        oseeds = torch.empty((2, 4, d2, B), dtype=torch.int32, device=dev)
        oflags = torch.empty((d2, B), dtype=torch.uint8, device=dev)
    lib = _lib()
    rc = lib.fhh_expand_launch(
        seed.data_ptr(), t.data_ptr(), y.data_ptr(), cws.data_ptr(),
        cwf.data_ptr(), packed.data_ptr(),
        oseeds.data_ptr() if want_children else None,
        oflags.data_ptr() if want_children else None,
        B, N, d2, int(bool(derived_bits)), int(bool(want_children)),
        cuda_build.stream_ptr(t),
    )
    cuda_build.check(lib, rc, "expand")
    LAUNCHES += 1
    return packed, oseeds, oflags
