"""The 1-of-2^S equality OT: CUDA kernels (``csrc/ot2s.cu``) and their plain
versions.

Replaces ``fuzzyheavyhitters_tpu/ops/otext_pallas.py:_enc_planar`` and
``:_dec_planar``, with their interface: the rows go in test-major, the
sender's table comes out as the planar wire (slot c, word w of test t at
``(c * W + w) * bp + t``, int32 words, ``bp = gc.padded_tests(B)``):

    enc_planar(q_rows [B, S, 4], s_block, x bool[B, S], m_v0/m_v1 [B, W],
               idx0[, bp]) -> table int32[(2^S * W) * bp]
    dec_planar(t_rows [B, S, 4], y bool[B, S], table, idx0) -> pay int32[B, W]

``s_block`` is the sender's uint32[4] ``s`` on the host; the kernel hashes
under the offsets ``otext.gf128_offsets(s, S)`` with the pad domain
``OT2S_DOMAIN`` XORed into word 1, which its launcher computes on the host.
Decrypt folds the domain into row 0, word 1 of its (real) tests itself.
Pad tests t in [B, bp) encrypt zero rows, zero choice and zero payload.
Test t's pad index is ``idx0 + t`` mod 2^32.  ``dec_planar`` takes the
table raveled (the wire), as planes [2^S * W, n >= B] or test-major
[2^S, n >= B, W], at any strides.  The wrappers launch the kernel for CUDA
tensors and run the plain version for CPU tensors; there is no fallback
from one to the other.  ``ENC_LAUNCHES`` and ``DEC_LAUNCHES`` count kernel
launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build, otext, prg
from .gc import padded_tests
from ..utils import words_from_numpy

ENC_LAUNCHES = 0
DEC_LAUNCHES = 0
KERNEL_S = (2, 4, 6)  # string widths csrc/ot2s.cu is compiled for
KERNEL_W = (4, 8)  # payload words (FE62, F255)
OT2S_DOMAIN = 0x0F4E4F54  # ot_hash tweak domain of the per-test pads


def _x_int(bits: torch.Tensor) -> torch.Tensor:
    """[B, S] 0/1 -> int64[B] little-endian S-bit integers."""
    sh = torch.arange(bits.shape[1], device=bits.device)
    return ((bits.to(torch.int64) & 1) << sh).sum(dim=1)


def ot2s_encrypt(q_rows, offs, x_flat, m_v0, m_v1, n_words: int, idx_offset: int):
    """Sender table, test-major (``secure.ot2s_encrypt`` of the JAX package):
    q_rows int32[B, S, 4], offs int32[2^S, 4] (domain folded), x_flat 0/1
    [B, S], payloads int32[B, n_words] -> cts int32[2^S, B, n_words]; the
    receiver with string y opens slot y = Σ y_j·2^j."""
    S = q_rows.shape[1]
    comb = otext.gf128_comb(q_rows)  # [B, 4]
    pads = otext.ot_hash(comb[None] ^ offs[:, None, :], n_words, idx_offset)
    c = torch.arange(1 << S, device=q_rows.device)
    eq = (c[:, None] == _x_int(x_flat)[None])[..., None]
    return torch.where(eq, m_v1[None], m_v0[None]) ^ pads


def ot2s_decrypt(t_rows, y_flat, cts, n_words: int, idx_offset: int):
    """Receiver open, test-major: t_rows int32[B, S, 4] (domain folded into
    row 0 word 1), y_flat 0/1 [B, S], cts int32[2^S, B, n_words] ->
    int32[B, n_words] = m_{[x == y]}, by the JAX package's one-hot sum."""
    S = t_rows.shape[1]
    pad = otext.ot_hash(otext.gf128_comb(t_rows), n_words, idx_offset)
    c = torch.arange(1 << S, device=t_rows.device)
    sel = (c[:, None] == _x_int(y_flat)[None]).to(torch.int64)[..., None]
    ct = (prg.to_u64(cts) * sel).sum(dim=0)
    return prg.to_i32(ct) ^ pad


def _padded(a: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ...] -> [n, ...], zero rows past B."""
    out = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    out[:a.shape[0]] = a
    return out


_DOMAIN_I32 = OT2S_DOMAIN - (1 << 32) if OT2S_DOMAIN >> 31 else OT2S_DOMAIN


def offsets(s_block, S: int, device) -> torch.Tensor:
    """The encrypt kernel's int32[2^S, 4] offsets: ``gf128_offsets(s, S)``
    with the pad domain folded into word 1."""
    offs = otext.gf128_offsets(words_from_numpy(s_block, device), S)
    offs[:, 1] ^= _DOMAIN_I32
    return offs


def enc_planar_plain(q_rows, s_block, x, m_v0, m_v1, idx0: int, bp=None):
    """Plain version of the encrypt kernel (the JAX package's
    ``_ot2s_encrypt_packed_xla``: the table over bp tests, pad tests
    encrypted from zero inputs)."""
    B, S, W = q_rows.shape[0], q_rows.shape[1], m_v0.shape[1]
    bp = padded_tests(B) if bp is None else bp
    offs = offsets(s_block, S, q_rows.device)
    cts = ot2s_encrypt(_padded(q_rows, bp), offs, _padded(x, bp), _padded(m_v0, bp),
                       _padded(m_v1, bp), W, idx0)  # [2^S, bp, W]
    return cts.permute(0, 2, 1).reshape(-1)


def table_strides(table: torch.Tensor, S: int, B: int):
    """(W, slot, test and word strides in words, tests per plane) of a
    table raveled over padded_tests(B) tests, as planes [2^S * W, n] or as
    test-major [2^S, n, W]."""
    C = 1 << S
    if table.dim() == 1:
        bp = padded_tests(B)
        W = table.shape[0] // (C * bp) if bp else 0
        if W * C * bp != table.shape[0] or table.stride(0) != 1:
            raise ValueError(f"ot2s decrypt: a raveled table must hold 2^S * W planes of "
                             f"{bp} tests, got {table.shape[0]} words")
        return W, W * bp, 1, bp, bp
    if table.dim() == 2:
        W = table.shape[0] // C
        if W * C != table.shape[0]:
            raise ValueError(f"ot2s decrypt: table planes {table.shape[0]} are not 2^S * W")
        sp, st = table.stride()
        return W, W * sp, st, sp, table.shape[1]
    if table.dim() == 3 and table.shape[0] == C:
        sc, st, sw = table.stride()
        return table.shape[2], sc, st, sw, table.shape[1]
    raise ValueError(f"ot2s decrypt: table must be raveled, [2^S * W, n] or [2^S, n, W], got "
                     f"{list(table.shape)}")


def table_view(table: torch.Tensor, S: int, B: int) -> torch.Tensor:
    """The table's first B tests as a [2^S, B, W] view."""
    W, sc, st, sw, _ = table_strides(table, S, B)
    return table.as_strided((1 << S, B, W), (sc, st, sw))


def dec_planar_plain(t_rows, y, table, idx0: int):
    """Plain version of the decrypt kernel (``_ot2s_decrypt_packed_xla``,
    the domain folded into row 0, word 1 as ``_dec_planar`` does)."""
    B, S = y.shape
    cts = table_view(table, S, B)
    t = t_rows.clone()
    t[:, 0, 1] ^= _DOMAIN_I32
    return ot2s_decrypt(t, y, cts, cts.shape[2], idx0)


def _lib():
    lib = cuda_build.load("ot2s")
    if lib.fhh_ot2s_enc_launch.argtypes is None:
        vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.fhh_ot2s_enc_launch.argtypes = [vp] * 4 + [ctypes.POINTER(u), u, vp, ll, ll, i, i,
                                                        u, vp]
        lib.fhh_ot2s_enc_launch.restype = i
        lib.fhh_ot2s_dec_launch.argtypes = [vp] * 3 + [ll] * 3 + [vp, ll, i, i, u, u, vp]
        lib.fhh_ot2s_dec_launch.restype = i
    return lib


def _rows(what: str, name: str, a, B: int, cols, dtype, dev):
    """Raise unless ``a`` is a ``dtype[B, *cols]`` on ``dev``, and on a card
    contiguous and 16-byte aligned where the kernel loads it in vectors."""
    if a.dtype != dtype or tuple(a.shape) != (B,) + cols or a.device != dev:
        raise ValueError(f"{what}: {name} must be {dtype}[{B}, {', '.join(map(str, cols))}] on "
                         f"{dev}, got {a.dtype}{list(a.shape)} on {a.device}")
    if dev.type == "cuda" and (not a.is_contiguous()
                               or (dtype == torch.int32 and a.data_ptr() % 16)):
        raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def enc_planar(q_rows, s_block, x, m_v0, m_v1, idx0: int, bp=None):
    """The sender table over bp tests (default ``padded_tests(B)``): the
    kernel on a CUDA device, the plain version on the CPU."""
    global ENC_LAUNCHES
    B, S = x.shape[0], x.shape[1] if x.dim() == 2 else 0
    W = m_v0.shape[1] if m_v0.dim() == 2 else 0
    dev = q_rows.device
    what = "ot2s encrypt"
    _rows(what, "q_rows", q_rows, B, (S, 4), torch.int32, dev)
    _rows(what, "x", x, B, (S,), torch.bool, dev)
    _rows(what, "m_v0", m_v0, B, (W,), torch.int32, dev)
    _rows(what, "m_v1", m_v1, B, (W,), torch.int32, dev)
    sb = np.asarray(s_block, np.uint32)
    if sb.shape != (4,):
        raise ValueError(f"{what}: s_block must be uint32[4], got {list(sb.shape)}")
    bp = padded_tests(B) if bp is None else bp
    if bp < B:
        raise ValueError(f"{what}: bp={bp} < B={B}")
    if dev.type == "cpu":
        return enc_planar_plain(q_rows, sb, x, m_v0, m_v1, idx0, bp)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    cuda_build.check_compiled("ot2s.cu", S, W, KERNEL_S, KERNEL_W)
    cts = torch.empty((1 << S) * W * bp, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.fhh_ot2s_enc_launch(q_rows.data_ptr(), x.data_ptr(), m_v0.data_ptr(),
                                 m_v1.data_ptr(), (ctypes.c_uint * 4)(*sb.tolist()),
                                 OT2S_DOMAIN, cts.data_ptr(), B, bp, S, W, idx0 & prg.M32,
                                 cuda_build.stream_ptr(q_rows))
    cuda_build.check(lib, rc, what)
    ENC_LAUNCHES += 1
    return cts


def dec_planar(t_rows, y, table, idx0: int):
    """The receiver open of B tests: the kernel on a CUDA device, the plain
    version on the CPU."""
    global DEC_LAUNCHES
    B, S = y.shape[0], y.shape[1] if y.dim() == 2 else 0
    dev = t_rows.device
    what = "ot2s decrypt"
    _rows(what, "t_rows", t_rows, B, (S, 4), torch.int32, dev)
    _rows(what, "y", y, B, (S,), torch.bool, dev)
    if table.dtype != torch.int32 or table.device != dev:
        raise ValueError(f"{what}: table must be int32 on {dev}, got {table.dtype} on "
                         f"{table.device}")
    W, sc, st, sw, n = table_strides(table, S, B)
    if n < B:
        raise ValueError(f"{what}: the table holds {n} tests, fewer than B={B}")
    if dev.type == "cpu":
        return dec_planar_plain(t_rows, y, table, idx0)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    cuda_build.check_compiled("ot2s.cu", S, W, KERNEL_S, KERNEL_W)
    pay = torch.empty((B, W), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.fhh_ot2s_dec_launch(t_rows.data_ptr(), y.data_ptr(), table.data_ptr(), sc, st, sw,
                                 pay.data_ptr(), B, S, W, idx0 & prg.M32, OT2S_DOMAIN,
                                 cuda_build.stream_ptr(t_rows))
    cuda_build.check(lib, rc, what)
    DEC_LAUNCHES += 1
    return pay

