"""The 1-of-2^S equality OT: CUDA kernels (``csrc/ot2s.cu``) and their plain
versions.

Replaces ``fuzzyheavyhitters_tpu/ops/otext_pallas.py:_enc_planar`` and
``:_dec_planar``.  Both versions share one plane-major interface over bp
tests (plane p of test t at ``[p, t]``, int32 words):

    enc_planar(q [4S, bp], x [S, bp] 0/1, mv0/mv1 [W, bp], offs [2^S, 4], idx0)
        -> cts [2^S * W, bp]   slot c, word w at plane c * W + w
    dec_planar(t [4S, bp], y [S, bp] 0/1, cts [2^S * W, bp], idx0)
        -> pay [W, bp]

``offs`` are ``otext.gf128_offsets(s, S)`` with the hash domain XORed into
word 1; the receiver's T planes carry the domain in row 0, word 1 (the JAX
package's folds).  Test t's pad index is ``idx0 + t`` mod 2^32.  The
wrappers launch the kernel for CUDA tensors and run the plain version for
CPU tensors; there is no fallback from one to the other.  ``ENC_LAUNCHES``
and ``DEC_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, otext, prg

ENC_LAUNCHES = 0
DEC_LAUNCHES = 0
KERNEL_S = (2, 4, 6)  # string widths csrc/ot2s.cu is compiled for
KERNEL_W = (4, 8)  # payload words (FE62, F255)


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


def _rows(planes: torch.Tensor) -> torch.Tensor:
    """[4S, n] planes -> [n, S, 4] rows."""
    return planes.T.reshape(planes.shape[1], planes.shape[0] // 4, 4)


def enc_planar_plain(q, x, mv0, mv1, offs, idx0: int):
    """Plain version of the encrypt kernel (the JAX package's
    ``_ot2s_encrypt_packed_xla`` on planar inputs)."""
    W = mv0.shape[0]
    cts = ot2s_encrypt(_rows(q), offs, x.T, mv0.T, mv1.T, W, idx0)  # [2^S, n, W]
    return cts.permute(0, 2, 1).reshape(-1, q.shape[1])


def dec_planar_plain(t, y, cts, idx0: int):
    """Plain version of the decrypt kernel (``_ot2s_decrypt_packed_xla``)."""
    n, S = t.shape[1], t.shape[0] // 4
    W = cts.shape[0] >> S
    c = cts.reshape(1 << S, W, n).permute(0, 2, 1)
    return ot2s_decrypt(_rows(t), y.T, c, W, idx0).T


def _lib():
    lib = cuda_build.load("ot2s")
    if lib.fhh_ot2s_enc_launch.argtypes is None:
        vp, ll, i, u = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
        lib.fhh_ot2s_enc_launch.argtypes = [vp] * 6 + [ll, i, i, u, vp]
        lib.fhh_ot2s_enc_launch.restype = i
        lib.fhh_ot2s_dec_launch.argtypes = [vp] * 4 + [ll, i, i, u, vp]
        lib.fhh_ot2s_dec_launch.restype = i
    return lib


def enc_planar(q, x, mv0, mv1, offs, idx0: int):
    """The sender table over bp tests: the kernel on a CUDA device, the plain
    version on the CPU."""
    global ENC_LAUNCHES
    S, n, W = x.shape[0], q.shape[1], mv0.shape[0]
    dev = cuda_build.check_planes(
        "ot2s encrypt", [("q", q, 4 * S), ("x", x, S), ("mv0", mv0, W), ("mv1", mv1, W)], n)
    if offs.dtype != torch.int32 or tuple(offs.shape) != (1 << S, 4) or offs.device != dev:
        raise ValueError(f"ot2s encrypt: offs must be int32[{1 << S}, 4] on {dev}")
    if dev.type == "cpu":
        return enc_planar_plain(q, x, mv0, mv1, offs, idx0)
    cuda_build.check_compiled("ot2s.cu", S, W, KERNEL_S, KERNEL_W)
    q, x, mv0, mv1, offs = (a.contiguous() for a in (q, x, mv0, mv1, offs))
    cts = torch.empty(((1 << S) * W, n), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.fhh_ot2s_enc_launch(q.data_ptr(), x.data_ptr(), mv0.data_ptr(), mv1.data_ptr(),
                                 offs.data_ptr(), cts.data_ptr(), n, S, W, idx0 & prg.M32,
                                 cuda_build.stream_ptr(q))
    cuda_build.check(lib, rc, "ot2s encrypt")
    ENC_LAUNCHES += 1
    return cts


def dec_planar(t, y, cts, idx0: int):
    """The receiver open over bp tests: the kernel on a CUDA device, the
    plain version on the CPU."""
    global DEC_LAUNCHES
    S, n = y.shape[0], t.shape[1]
    W = cts.shape[0] >> S
    dev = cuda_build.check_planes(
        "ot2s decrypt", [("t", t, 4 * S), ("y", y, S), ("cts", cts, (1 << S) * W)], n)
    if dev.type == "cpu":
        return dec_planar_plain(t, y, cts, idx0)
    cuda_build.check_compiled("ot2s.cu", S, W, KERNEL_S, KERNEL_W)
    t, y, cts = (a.contiguous() for a in (t, y, cts))
    pay = torch.empty((W, n), dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.fhh_ot2s_dec_launch(t.data_ptr(), y.data_ptr(), cts.data_ptr(), pay.data_ptr(),
                                 n, S, W, idx0 & prg.M32, cuda_build.stream_ptr(t))
    cuda_build.check(lib, rc, "ot2s decrypt")
    DEC_LAUNCHES += 1
    return pay
