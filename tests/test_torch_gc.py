"""The PyTorch port's garbled-circuit equality with b2a payloads
(``ops/gc.py``: the plain versions of the ``csrc/gc.cu`` kernels and the
packed entry points) against the JAX package, bit for bit, on the whole
planar message, pad slots included: S in {2, 4, 6, 8}, both payload widths,
a batch that is not a whole number of planar blocks, a non-zero pad index.

The JAX side is both its XLA twins (``gc._garble_equality_payload_packed_xla``
/ ``_eval_equality_payload_packed_xla``) and its Pallas kernels
``gc_pallas.garble_equality_payload_packed`` / ``eval_equality_payload_
packed`` themselves, whose bodies run op by op on their grid through
``torch_ref.pallas_eager``: XLA:CPU compiles a secure kernel in interpret
mode for minutes, past 12 GB.  (The JAX package pins the twins to the
kernels in ``tests/test_secure_kernels.py::test_gc_packed_engine_parity``,
a test that needs a JAX release that its ``ops/prg.py`` imports under.)"""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import gc as tgc
from fuzzyheavyhitters_torch.ops import gc_cuda
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

jgc, jgc_pallas = torch_ref.reference(
    "fuzzyheavyhitters_tpu.ops.gc", "fuzzyheavyhitters_tpu.ops.gc_pallas")


def _w(a):
    return words_from_numpy(a, "cpu")


@pytest.mark.parametrize("S", [2, 4, 6, 8])
@pytest.mark.parametrize("W", [4, 8])
def test_packed_garble_and_eval_match_jax(S, W):
    """Against the XLA twins and the Pallas kernels, over two planar blocks."""
    rng = np.random.default_rng(300 + 10 * S + W)
    B, idx0 = 9000, 2**32 - 5000  # the pad index wraps at test 5000
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    Y0 = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    m0 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    m1 = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)
    with torch_ref.installed():
        jmsg, jmask = jgc._garble_equality_payload_packed_xla(R, Y0, seed, x, m0, m1, W, idx0)
        with torch_ref.pallas_eager():
            pmsg, pmask = jgc_pallas.garble_equality_payload_packed(R, Y0, seed, x, m0, m1,
                                                                     W, idx0)
    jmsg = np.asarray(jmsg, np.uint32)
    tmsg, tmask = tgc.garble_equality_payload_packed(R, _w(Y0), seed, torch.from_numpy(x),
                                                     _w(m0), _w(m1), W, idx0)
    assert tmsg.shape == (tgc.packed_msg_words(B, S, W),)
    np.testing.assert_array_equal(words_to_numpy(tmsg), jmsg)
    np.testing.assert_array_equal(words_to_numpy(tmsg), np.asarray(pmsg))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(pmask))
    # the evaluator's active labels for a peer string y
    y = x.copy()
    y[::4] = ~y[::4]
    evl = Y0 ^ (y[..., None] * R)
    with torch_ref.installed():
        je, jpay = jgc._eval_equality_payload_packed_xla(jmsg, evl, S, W, idx0)
        with torch_ref.pallas_eager():
            pe, ppay = jgc_pallas.eval_equality_payload_packed(jmsg, evl, W, idx0)
    te, tpay = tgc.eval_equality_payload_packed(tmsg, _w(evl), W, idx0)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(te.numpy(), np.asarray(pe))
    np.testing.assert_array_equal(words_to_numpy(tpay), np.asarray(jpay, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tpay), np.asarray(ppay))
    eq = (x == y).all(axis=1)
    np.testing.assert_array_equal(tmask.numpy() ^ te.numpy(), eq)
    np.testing.assert_array_equal(words_to_numpy(tpay), np.where(eq[:, None], m1, m0))


@pytest.mark.parametrize("S", [3, 5])
def test_and_trees_match_jax_on_odd_widths(S):
    """Leftover wires carry to the next layer in the JAX package's order."""
    rng = np.random.default_rng(400 + S)
    B = 50
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    X0, Y0 = (rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32) for _ in range(2))
    mask = rng.integers(0, 2, size=B).astype(bool)
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    jb, jout = jgc._garble_core(R, X0, Y0, mask, x)
    tb, tout = tgc._garble_core(_w(R), _w(X0), _w(Y0), torch.from_numpy(mask),
                                torch.from_numpy(x))
    np.testing.assert_array_equal(words_to_numpy(tout), np.asarray(jout, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tb.tables), np.asarray(jb.tables, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tb.gb_labels),
                                  np.asarray(jb.gb_labels, np.uint32))
    np.testing.assert_array_equal(tb.decode.numpy(), np.asarray(jb.decode))
    act = X0 ^ Y0  # any active labels: the tree evaluations must agree
    np.testing.assert_array_equal(
        words_to_numpy(tgc._and_tree_eval(_w(act), tb.tables)),
        np.asarray(jgc._and_tree_eval(act, jb.tables), np.uint32))


def test_carve_label_words_matches_jax():
    seed = np.array([1, 2, 3, 4], np.uint32)
    jR, (jX,), jm = jgc._carve_label_words(seed, 70, 4, 1, with_r=True)
    tR, (tX,), tm = tgc._carve_label_words(_w(seed), 70, 4, 1, with_r=True)
    np.testing.assert_array_equal(words_to_numpy(tR), np.asarray(jR, np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tX), np.asarray(jX, np.uint32))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_gc_wrappers_check_inputs():
    z = lambda r, n=64: torch.zeros((r, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="lsb"):
        gc_cuda.garble_planar([2, 0, 0, 0], z(8), z(8), z(2), z(1), z(4), z(4), 0)
    with pytest.raises(ValueError, match="int32"):
        gc_cuda.garble_planar([1, 0, 0, 0], z(8), z(8), z(3), z(1), z(4), z(4), 0)
    with pytest.raises(ValueError):
        gc_cuda.eval_planar(z(8), z(8), z(9), z(1), z(8), 0)
    assert tgc.padded_tests(1) == 8192 and tgc.padded_tests(8192) == 8192
