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
