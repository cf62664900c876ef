"""The PyTorch port's FE62 and F255 (``fuzzyheavyhitters_torch/ops/fields.py``)
against the JAX package's fields, bit for bit (tolerance 0: field values
are integers), on random values and on the edges: 0, 1, p - 1, and FE62's
lazy range up to about 2^62 + 2^31, where the port's int64 arithmetic wraps
and its masked shifts must stand in for the unsigned ones."""

import numpy as np
import pytest
import torch

import torch_ref
from fuzzyheavyhitters_torch.ops import fields as tf
from fuzzyheavyhitters_torch.utils import words_from_numpy, words_to_numpy

(jf,) = torch_ref.reference("fuzzyheavyhitters_tpu.ops.fields")

P62 = (1 << 62) - (1 << 30) - 1
P255 = (1 << 255) - 19


def _fe62_values(rng, n):
    edges = [0, 1, 2, P62 - 1, P62, P62 + 1, (1 << 62) - 1, 1 << 62,
             (1 << 62) + (1 << 31), (1 << 62) + (1 << 31) - 1, 2 * P62 - 1]
    rand = rng.integers(0, (1 << 62) + (1 << 31), size=n - len(edges), dtype=np.uint64)
    return np.concatenate([np.array(edges, np.uint64), rand])


def _t62(a):
    return torch.from_numpy(np.asarray(a, np.uint64).view(np.int64).copy())


def _n62(t):
    return t.numpy().view(np.uint64)


def _limbs(vals):
    return np.array([[(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for v in vals],
                    np.uint32)


def _f255_values(rng, n):
    edges = [0, 1, 2, P255 - 1, P255 - 2, 19, (1 << 255) - 20]
    rand = [int.from_bytes(rng.bytes(32), "little") % P255 for _ in range(n - len(edges))]
    return _limbs(edges + rand)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_fe62_binary_ops_match_jax(op):
    rng = np.random.default_rng(1)
    a, b = _fe62_values(rng, 64), rng.permutation(_fe62_values(rng, 64))
    want = np.asarray(getattr(jf.FE62, op)(a, b), np.uint64)
    got = _n62(getattr(tf.FE62, op)(_t62(a), _t62(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["canon", "neg", "new"])
def test_fe62_unary_ops_match_jax(op):
    a = _fe62_values(np.random.default_rng(2), 64)
    np.testing.assert_array_equal(_n62(getattr(tf.FE62, op)(_t62(a))),
                                  np.asarray(getattr(jf.FE62, op)(a), np.uint64))


def test_fe62_blocks_sample_sum_and_ints_match_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2**32, size=(97, 4), dtype=np.uint32)
    words[:4] = [[0, 0, 0, 0], [0xFFFFFFFF] * 4, [1, 0, 0, 0], [0, 0x3FFFFFFF, 0, 0]]
    tw = words_from_numpy(words, "cpu")
    np.testing.assert_array_equal(_n62(tf.FE62.sample(tw)),
                                  np.asarray(jf.FE62.sample(words), np.uint64))
    np.testing.assert_array_equal(_n62(tf.FE62.from_blocks(tw)),
                                  np.asarray(jf.FE62.from_blocks(words), np.uint64))
    a = _fe62_values(rng, 97)
    np.testing.assert_array_equal(words_to_numpy(tf.FE62.to_blocks(_t62(a))),
                                  np.asarray(jf.FE62.to_blocks(a), np.uint32))
    v = a.reshape(1, 97)
    np.testing.assert_array_equal(_n62(tf.FE62.sum(_t62(v), dim=1)),
                                  np.asarray(jf.FE62.sum(v, axis=1), np.uint64))
    np.testing.assert_array_equal(tf.FE62.to_numpy_ints(_t62(a)), jf.FE62.to_numpy_ints(a))
    assert int(tf.FE62.from_int(-1)) == int(jf.FE62.from_int(-1))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_f255_binary_ops_match_jax(op):
    rng = np.random.default_rng(4)
    a, b = _f255_values(rng, 40), rng.permutation(_f255_values(rng, 40))
    want = np.asarray(getattr(jf.F255, op)(a, b), np.uint32)
    got = words_to_numpy(getattr(tf.F255, op)(words_from_numpy(a, "cpu"),
                                              words_from_numpy(b, "cpu")))
    np.testing.assert_array_equal(got, want)


def test_f255_unary_blocks_and_sample_match_jax():
    rng = np.random.default_rng(5)
    a = _f255_values(rng, 40)
    ta = words_from_numpy(a, "cpu")
    np.testing.assert_array_equal(words_to_numpy(tf.F255.neg(ta)),
                                  np.asarray(jf.F255.neg(a), np.uint32))
    raw = rng.integers(0, 2**32, size=(40, 8), dtype=np.uint32)
    raw[:3] = [[0xFFFFFFFF] * 8, _limbs([P255])[0], _limbs([P255 + 18])[0]]
    tr = words_from_numpy(raw, "cpu")
    np.testing.assert_array_equal(words_to_numpy(tf.F255.sample(tr)),
                                  np.asarray(jf.F255.sample(raw), np.uint32))
    blocks = raw.reshape(40, 2, 4)
    np.testing.assert_array_equal(
        words_to_numpy(tf.F255.from_blocks(words_from_numpy(blocks, "cpu"))),
        np.asarray(jf.F255.from_blocks(blocks), np.uint32))
    np.testing.assert_array_equal(words_to_numpy(tf.F255.to_blocks(ta)),
                                  np.asarray(jf.F255.to_blocks(a), np.uint32))
    assert list(tf.F255.to_numpy_ints(ta)) == list(jf.F255.to_numpy_ints(a))
    for x in (0, 1, -1, P255 + 5):
        np.testing.assert_array_equal(words_to_numpy(tf.F255.from_int(x)),
                                      np.asarray(jf.F255.from_int(x), np.uint32))


@pytest.mark.parametrize("n", [1, 7, 300])
def test_f255_sum_matches_jax_tree(n):
    """The port sums limb columns in int64 and folds once; the JAX package
    adds pairwise in a tree: the canonical results agree, including sums
    that wrap p several times."""
    rng = np.random.default_rng(6 + n)
    v = _f255_values(rng, 3 * n)[:3 * n].reshape(3, n, 8)
    v[0] = _limbs([P255 - 1] * n)  # every term at p - 1
    want = np.asarray(jf.F255.sum(v, axis=1), np.uint32)
    got = words_to_numpy(tf.F255.sum(words_from_numpy(v, "cpu"), dim=1))
    np.testing.assert_array_equal(got, want)
    assert tf.F255.to_numpy_ints(words_from_numpy(got, "cpu"))[0] == (n * (P255 - 1)) % P255


# -- the sketch's field surface: F255.mul, pow_const, recip, ge, eq, U63, Dummy --


def test_f255_mul_matches_jax():
    """The 8x8 product at the edges (p - 1 squared, products that wrap the
    int64 partials past 2^63) and on random values."""
    rng = np.random.default_rng(7)
    a, b = _f255_values(rng, 48), rng.permutation(_f255_values(rng, 48))
    a[:2] = _limbs([P255 - 1, P255 - 1])
    b[:2] = _limbs([P255 - 1, P255 - 2])
    want = np.asarray(jf.F255.mul(a, b), np.uint32)
    got = words_to_numpy(tf.F255.mul(words_from_numpy(a, "cpu"), words_from_numpy(b, "cpu")))
    np.testing.assert_array_equal(got, want)
    assert tf.F255.to_numpy_ints(words_from_numpy(got[:1], "cpu"))[0] == 1  # (-1)^2


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("e", [0, 1, 2, 5, 1000003, "p-2"])
def test_pow_const_and_recip_match_jax(field, e):
    rng = np.random.default_rng(8)
    if field == "FE62":
        a = _fe62_values(rng, 16)
        to_t, to_n = _t62, _n62
    else:
        a = _f255_values(rng, 16)
        to_t, to_n = (lambda x: words_from_numpy(x, "cpu")), words_to_numpy
    jfield, tfield = getattr(jf, field), getattr(tf, field)
    if e == "p-2":
        want, got = jfield.recip(a), tfield.recip(to_t(a))
    else:
        want, got = jfield.pow_const(a, e), tfield.pow_const(to_t(a), e)
    np.testing.assert_array_equal(to_n(got), np.asarray(want))


@pytest.mark.parametrize("field", ["FE62", "F255"])
def test_ge_and_eq_match_jax(field):
    rng = np.random.default_rng(9)
    if field == "FE62":
        a = _fe62_values(rng, 40)
        b = np.concatenate([a[:10], rng.permutation(_fe62_values(rng, 40))[10:]])
        b[10] = np.uint64((int(a[10]) % P62) + P62)  # the same residue, another word
        to_t = _t62
    else:
        a = _f255_values(rng, 40)
        b = np.concatenate([a[:10], rng.permutation(_f255_values(rng, 40))[10:]])
        b[10] = a[10]
        b[11, :7] = a[11, :7]  # differ in the top limb only
        to_t = lambda x: words_from_numpy(x, "cpu")
    jfield, tfield = getattr(jf, field), getattr(tf, field)
    for op in ("ge", "eq"):
        np.testing.assert_array_equal(getattr(tfield, op)(to_t(a), to_t(b)).numpy(),
                                      np.asarray(getattr(jfield, op)(a, b)))
        np.testing.assert_array_equal(getattr(tfield, op)(to_t(b), to_t(a)).numpy(),
                                      np.asarray(getattr(jfield, op)(b, a)))


P63 = (1 << 63) - 25


def _u63_values(rng, n):
    """Canonical values and raw words at and past 2^63 (sums and pre-fold
    words reach there)."""
    edges = [0, 1, 24, 25, P63 - 1, P63, P63 + 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 24,
             (1 << 63) + 25, (1 << 64) - 1, (1 << 64) - 26]
    rand = rng.integers(0, 2**64 - 1, size=n - len(edges), dtype=np.uint64, endpoint=True)
    return np.concatenate([np.array(edges, np.uint64), rand])


@pytest.mark.parametrize("op", ["add", "sub", "mul", "eq", "canon", "neg", "sample", "sum",
                                "ints"])
def test_u63_matches_jax(op):
    rng = np.random.default_rng(10)
    a, b = _u63_values(rng, 48), rng.permutation(_u63_values(rng, 48))
    if op in ("add", "sub", "mul", "eq"):
        want = np.asarray(getattr(jf.U63, op)(a, b))
        got = getattr(tf.U63, op)(_t62(a), _t62(b)).numpy()
    elif op in ("canon", "neg"):
        want, got = np.asarray(getattr(jf.U63, op)(a)), getattr(tf.U63, op)(_t62(a)).numpy()
    elif op == "sample":
        words = rng.integers(0, 2**32, size=(48, 4), dtype=np.uint32)
        words[:2] = [[0xFFFFFFFF] * 4, [0, 0x80000000, 0xFFFFFFFF, 0xFFFFFFFF]]
        want = np.asarray(jf.U63.sample(words))
        got = tf.U63.sample(words_from_numpy(words, "cpu")).numpy()
    elif op == "sum":
        v = a.reshape(6, 8)
        want = np.asarray(jf.U63.sum(v, axis=1))
        got = tf.U63.sum(_t62(v), dim=1).numpy()
    else:
        np.testing.assert_array_equal(tf.U63.to_numpy_ints(_t62(a)), jf.U63.to_numpy_ints(a))
        assert int(tf.U63.from_int(-1)) == int(jf.U63.from_int(-1))
        return
    if got.dtype == np.int64:
        got = got.view(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_dummy_matches_jax():
    """Every op of the no-op group gives the JAX package's zeros (and eq's
    ones) in its shapes."""
    a = np.arange(12, dtype=np.uint32).reshape(3, 4)
    ta = words_from_numpy(a, "cpu")
    for op in ("add", "sub", "mul"):
        np.testing.assert_array_equal(getattr(tf.Dummy, op)(ta, ta).numpy(),
                                      np.asarray(getattr(jf.Dummy, op)(a, a)))
    for op in ("canon", "neg"):
        np.testing.assert_array_equal(getattr(tf.Dummy, op)(ta).numpy(),
                                      np.asarray(getattr(jf.Dummy, op)(a)))
    np.testing.assert_array_equal(tf.Dummy.eq(ta, ta).numpy(), np.asarray(jf.Dummy.eq(a, a)))
    np.testing.assert_array_equal(tf.Dummy.sample(ta).numpy(), np.asarray(jf.Dummy.sample(a)))
    np.testing.assert_array_equal(tf.Dummy.sum(ta, dim=1).numpy(),
                                  np.asarray(jf.Dummy.sum(a, axis=1)))
    assert tf.Dummy.zeros((2, 3)).shape == jf.Dummy.zeros((2, 3)).shape
    assert int(tf.Dummy.from_int(5)) == int(jf.Dummy.from_int(5)) == 0
