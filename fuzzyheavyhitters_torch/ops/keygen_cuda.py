"""ibDCF keygen: the CUDA kernel (``csrc/keygen.cu``) and its plain version.

Replaces ``fuzzyheavyhitters_tpu/ops/keygen_pallas.py:_gen_pallas``.  Both
versions share one interface on a flat batch of K keys:

    init_seeds int32[K, 2, 4]  (party axis of 2), alpha bool[K, L],
    side bool[K]  ->  cw_seed int32[K, L, 4], cw_bits bool[K, L, 2],
                      cw_y bool[K, L, 2]

:func:`gen_cw` launches the kernel for CUDA tensors and runs
:func:`gen_cw_plain` for CPU tensors; there is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, prg

LAUNCHES = 0


def gen_cw_plain(init_seeds, alpha, side, derived_bits: bool):
    """The level recurrence in plain PyTorch (ibDCF.rs:84-164), the same
    arithmetic as ``ibdcf.gen_pair_np`` of the JAX package: every key of
    the batch advances one level per loop step."""
    K, L = alpha.shape
    dev = alpha.device
    s = prg.to_u64(init_seeds)  # [K, 2, 4]
    seeds = [s[..., w] for w in range(4)]  # each [K, 2]
    tbits = torch.tensor([False, True], device=dev).expand(K, 2)
    side = side.to(torch.bool)
    cw_seed = torch.empty((K, L, 4), dtype=torch.int32, device=dev)
    cw_bits = torch.empty((K, L, 2), dtype=torch.bool, device=dev)
    cw_y = torch.empty((K, L, 2), dtype=torch.bool, device=dev)
    for lvl in range(L):
        sl, sr, (tl, tr), (yl, yr) = prg.expand_words(seeds, derived_bits)
        keep = alpha[:, lvl]
        cw = [torch.where(keep, a[:, 0] ^ a[:, 1], b[:, 0] ^ b[:, 1])
              for a, b in zip(sl, sr)]
        cw_seed[:, lvl] = prg.to_i32(torch.stack(cw, dim=-1))
        cwb_l = tl[:, 0] ^ tl[:, 1] ^ ~keep
        cwb_r = tr[:, 0] ^ tr[:, 1] ^ keep
        cw_bits[:, lvl, 0] = cwb_l
        cw_bits[:, lvl, 1] = cwb_r
        cw_y[:, lvl, 0] = yl[:, 0] ^ yl[:, 1] ^ (keep & ~side)
        cw_y[:, lvl, 1] = yr[:, 0] ^ yr[:, 1] ^ (~keep & side)
        k2 = keep[:, None]
        cw_keep = torch.where(keep, cwb_r, cwb_l)[:, None]
        kept = [torch.where(k2, b, a) for a, b in zip(sl, sr)]
        seeds = [torch.where(tbits, k ^ c[:, None], k) for k, c in zip(kept, cw)]
        tbits = torch.where(k2, tr, tl) ^ (tbits & cw_keep)
    return cw_seed, cw_bits, cw_y


def _lib():
    lib = cuda_build.load("keygen")
    if lib.fhh_keygen_launch.argtypes is None:
        vp = ctypes.c_void_p
        lib.fhh_keygen_launch.argtypes = [vp] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
        lib.fhh_keygen_launch.restype = ctypes.c_int
    return lib


def _check(init_seeds, alpha, side):
    K, L = alpha.shape
    dev = alpha.device
    for name, t, dtype, shape in (
        ("init_seeds", init_seeds, torch.int32, (K, 2, 4)),
        ("alpha", alpha, torch.bool, (K, L)),
        ("side", side, torch.bool, (K,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, alpha on {dev}")


def gen_cw(init_seeds, alpha, side, derived_bits: bool | None = None):
    """Correction words of K keys: the kernel on a CUDA device, the plain
    version on the CPU (see the module docstring for shapes)."""
    global LAUNCHES
    if derived_bits is None:
        derived_bits = prg.DERIVED_BITS
    _check(init_seeds, alpha, side)
    if alpha.device.type == "cpu":
        return gen_cw_plain(init_seeds, alpha, side, derived_bits)
    if alpha.device.type != "cuda":
        raise ValueError(f"keygen runs on cuda or cpu, not {alpha.device}")
    if prg.N_ROUNDS != 8:
        raise ValueError("csrc/chacha.cuh is compiled for N_ROUNDS = 8")
    K, L = alpha.shape
    init_seeds, alpha, side = (t.contiguous() for t in (init_seeds, alpha, side))
    if init_seeds.data_ptr() % 16:  # the kernel loads seeds as 16-byte uint4
        init_seeds = init_seeds.clone()
    cw_seed = torch.empty((K, L, 4), dtype=torch.int32, device=alpha.device)
    cw_bits = torch.empty((K, L, 2), dtype=torch.bool, device=alpha.device)
    cw_y = torch.empty((K, L, 2), dtype=torch.bool, device=alpha.device)
    lib = _lib()
    rc = lib.fhh_keygen_launch(
        init_seeds.data_ptr(), alpha.data_ptr(), side.data_ptr(),
        cw_seed.data_ptr(), cw_bits.data_ptr(), cw_y.data_ptr(),
        K, L, int(bool(derived_bits)), cuda_build.stream_ptr(alpha),
    )
    cuda_build.check(lib, rc, "keygen")
    LAUNCHES += 1
    return cw_seed, cw_bits, cw_y
