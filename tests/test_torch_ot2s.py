"""The PyTorch port's 1-of-2^S equality OT (``ops/otext_cuda.py``: the plain
versions of the ``csrc/ot2s.cu`` kernels, and ``protocol/secure.py``'s
packed entry points) against the JAX package, bit for bit, on the whole
planar buffer, pad slots included: S in {2, 4, 6}, both payload widths, a
batch that is not a whole number of planar blocks, a non-zero pad index.

The JAX side is both its XLA twins (``secure._ot2s_encrypt_packed_xla`` /
``_ot2s_decrypt_packed_xla``) and its Pallas kernels
``otext_pallas._enc_planar`` / ``_dec_planar`` themselves, whose bodies
run op by op on their grid through ``torch_ref.pallas_eager``: XLA:CPU
compiles even the S = 2 kernel in interpret mode for minutes, past 12 GB.
(The JAX package pins the twins to the kernels in
``tests/test_secure_kernels.py::test_ot2s_planar_engine_parity``, a test
that needs a JAX release that its ``ops/prg.py`` imports under.)"""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import otext as totext
from fuzzyheavyhitters_torch.ops import otext_cuda
from fuzzyheavyhitters_torch.protocol import secure as tsecure
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jsecure, jotext_pallas = torch_ref.reference(
    "fuzzyheavyhitters_tpu.protocol.secure", "fuzzyheavyhitters_tpu.ops.otext_pallas")


def _w(a):
    return words_from_numpy(a, "cpu")


def _inputs(rng, B, S, W):
    q = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    s = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    s[0] |= 1
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    m0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    m1 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    return q, s, x, m0, m1


@pytest.mark.parametrize("S", [2, 4, 6])
@pytest.mark.parametrize("W", [4, 8])
def test_ot2s_packed_planes_match_jax(S, W):
    """Against the XLA twins and the Pallas kernels, over two planar blocks."""
    rng = np.random.default_rng(100 + 10 * S + W)
    B, idx0 = 9000, 2**32 - 5000  # the pad index wraps at test 5000
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    with torch_ref.installed():
        jmsg = np.asarray(jsecure._ot2s_encrypt_packed_xla(q, s, x, m0, m1, W, idx0),
                          np.uint32)
        with torch_ref.pallas_eager():
            pmsg = np.asarray(jotext_pallas.ot2s_encrypt(q, s, x, m0, m1, W, idx0,
                                                         domain=jsecure._OT2S_DOMAIN))
    tmsg = tsecure.ot2s_encrypt_packed(_w(q), s, torch.from_numpy(x), _w(m0), _w(m1),
                                       W, idx0)
    assert tmsg.shape == ((1 << S) * W * 2 * 8192,)  # B pads to two planar blocks
    np.testing.assert_array_equal(words_to_numpy(tmsg), jmsg)
    np.testing.assert_array_equal(words_to_numpy(tmsg), pmsg)
    # the receiver: T rows for string y (Δ-OT: t_j = q_j ^ y_j·s)
    y = x.copy()
    y[::3] = ~y[::3]
    t = q ^ (y[..., None] * s)
    with torch_ref.installed():
        jpay = np.asarray(jsecure._ot2s_decrypt_packed_xla(t, y, jmsg, S, W, idx0), np.uint32)
        with torch_ref.pallas_eager():
            ppay = np.asarray(jotext_pallas.ot2s_decrypt(t, y, jmsg, W, idx0,
                                                         domain=jsecure._OT2S_DOMAIN))
    tpay = tsecure.ot2s_decrypt_packed(_w(t), torch.from_numpy(y), tmsg, W, idx0)
    np.testing.assert_array_equal(words_to_numpy(tpay), jpay)
    np.testing.assert_array_equal(words_to_numpy(tpay), ppay)
    eq = (x == y).all(axis=1)
    np.testing.assert_array_equal(words_to_numpy(tpay), np.where(eq[:, None], m1, m0))


@pytest.mark.parametrize("S", [2, 4])
def test_ot2s_test_major_forms_match_jax(S):
    rng = np.random.default_rng(200 + S)
    B, W, idx0 = 300, 4, 2**32 - 100  # the pad index wraps inside the batch
    q, s, x, m0, m1 = _inputs(rng, B, S, W)
    with torch_ref.installed():
        jcts = np.asarray(jsecure.ot2s_encrypt(q, s, x, m0, m1, W, idx0), np.uint32)
    offs = totext.gf128_offsets(_w(s), S)
    offs[:, 1] ^= tsecure._OT2S_DOMAIN
    tcts = otext_cuda.ot2s_encrypt(_w(q), offs, torch.from_numpy(x), _w(m0), _w(m1), W, idx0)
    np.testing.assert_array_equal(words_to_numpy(tcts), jcts)
    t = q.copy()
    t[:, 0, 1] ^= np.uint32(tsecure._OT2S_DOMAIN)
    with torch_ref.installed():
        jpay = np.asarray(jsecure.ot2s_decrypt(q, x, jcts, W, idx0), np.uint32)
    tpay = otext_cuda.ot2s_decrypt(_w(t), torch.from_numpy(x), tcts, W, idx0)
    np.testing.assert_array_equal(words_to_numpy(tpay), jpay)


def test_ot2s_wrappers_check_inputs():
    z = lambda r, n=8192: torch.zeros((r, n), dtype=torch.int32)
    offs = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        otext_cuda.enc_planar(z(8), z(2).to(torch.int64), z(4), z(4), offs, 0)
    with pytest.raises(ValueError, match="offs"):
        otext_cuda.enc_planar(z(8), z(2), z(4), z(4), offs[:2], 0)
    with pytest.raises(ValueError):
        otext_cuda.dec_planar(z(8), z(2), z(15), 0)
    out = otext_cuda.enc_planar(z(8, 5), z(2, 5), z(4, 5), z(4, 5), offs, 0)
    assert out.shape == (16, 5)
