"""The PyTorch port's row-sharded sketch check (``parallel/sketch_shard.py``)
against the JAX package's ``parallel/sketch_shard.py`` (its shards on the
conftest's virtual CPU devices), tolerance zero, at k in {1, 2, 4} shards
and on batches the budget does not divide:

- the challenge stream (``stream_parts``): the per-node r and every
  shard's seek into the (client·dim) rows;
- the three stages on real level-0 pair shares of honest clients (the
  DPF walk of ``sketch.gen``'s keys, both children of every root), both
  roles: the cor wire stack and the out shares byte-equal to the JAX
  package's, and the verdicts (every client passes);
- the same on random pair shares (every client fails);
- ``sketch_shards``/``bind`` degrade as the JAX package's.

The JAX package's functions run inside ``torch_ref.installed()``."""

import numpy as np
import pytest
import torch

import fuzzyheavyhitters_tpu.ops.fields  # noqa: F401  (one fields module under every torch_ref
# load, whatever other files a worker collects: the JAX functions compare field classes by
# identity, and tests/test_fields.py imports it so in a whole run)
import torch_ref
from fuzzyheavyhitters_torch.ops import dpf as tdpf
from fuzzyheavyhitters_torch.ops import fields as tf
from fuzzyheavyhitters_torch.parallel import sketch_shard as tss
from fuzzyheavyhitters_torch.protocol import mpc as tmpc
from fuzzyheavyhitters_torch.protocol import sketch as tsk

(jss, jsk, jf, jmpc) = torch_ref.reference(
    "fuzzyheavyhitters_tpu.parallel.sketch_shard", "fuzzyheavyhitters_tpu.protocol.sketch",
    "fuzzyheavyhitters_tpu.ops.fields", "fuzzyheavyhitters_tpu.protocol.mpc")

import jax  # noqa: E402  (after the reference import, as the other parity tests)

L, D = 5, 2
CPU = torch.device("cpu")
SEED = np.array([3, 0xFFFFFFFF, 11, 12], np.uint32)


def _binds(n, budget):
    """(port binding, JAX binding) of an n-client batch under a budget."""
    t = tss.bind((CPU,) * 8, n, D, budget)
    j = jss.bind(tuple(jax.devices()[:8]), n, D, budget)
    assert (t is None) == (j is None) and (t is None or t.k == j.k)
    return t, j


def _level0(n, seed=0):
    """Both parties' level-0 checks of honest clients: (pairs, triple
    slab, MAC shares, MAC² shares) a party, in the port's tensors and the
    JAX package's arrays (byte-equal keys)."""
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 2, size=(n, D, L)).astype(bool)
    seeds = rng.integers(0, 2**32, size=(n, D, 2, 4), dtype=np.uint32)
    cseed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    sks = tsk.gen(seeds, alpha, tf.FE62, tf.F255, cseed, device="cpu")
    port, jax_in = [], []
    for sk in sks:
        k = sk.key
        root = tdpf.eval_init(k)
        sides = [tdpf.eval_bit(tdpf.level_cw(k, 0), root, torch.full((n, D), c),
                               k.cw_val[..., 0, :], k.key_idx, tf.FE62, tsk.LANES)[1]
                 for c in (False, True)]
        pairs = torch.stack(sides)
        trip = tmpc.level_slab(sk.triples, 0)
        port.append((pairs, trip, sk.mac_key, sk.mac_key2))
        jax_in.append((tsk.wire(pairs), jmpc.TripleBatch(*(tsk.wire(x) for x in trip)),
                       tsk.wire(sk.mac_key), tsk.wire(sk.mac_key2)))
    return port, jax_in


def _random(n, field, seed=1):
    rng = np.random.default_rng(seed)
    w = 8 if field is tf.F255 else 4
    draw = lambda *shape: field.np_sample(rng.integers(0, 2**32, size=shape + (w,),
                                                       dtype=np.uint32))
    port, jax_in = [], []
    for _ in (0, 1):
        pairs, mk, mk2 = draw(3, n, D, 2), draw(n), draw(n)
        trip = [draw(n, D, tmpc.CHECKS) for _ in range(3)]
        port.append((tsk.from_wire(pairs, "cpu"), tmpc.TripleBatch(
            *(tsk.from_wire(x, "cpu") for x in trip)), tsk.from_wire(mk, "cpu"),
            tsk.from_wire(mk2, "cpu")))
        jax_in.append((pairs, jmpc.TripleBatch(*trip), mk, mk2))
    return port, jax_in


def _port_chain(ss, field, inputs, level):
    cor, st = zip(*(tss.cor_state(ss, field, *inputs[p], SEED, level) for p in (0, 1)))
    cor_w = [tss.wire(c) for c in cor]
    o = [tss.out_shares(ss, field, st[p], cor[p], cor_w[1 - p], bool(p)) for p in (0, 1)]
    o_w = [tss.wire(x) for x in o]
    return cor_w, o_w, tss.verdicts(ss, field, o[0], o_w[1]).numpy()


def _jax_chain(ss, field, inputs, level):
    with torch_ref.installed():
        cor, st = zip(*(jss.cor_state(ss, field, *inputs[p], SEED, level) for p in (0, 1)))
        cor_w = [jss.wire(c) for c in cor]
        o = [jss.out_shares(ss, field, st[p], cor[p], cor_w[1 - p], bool(p)) for p in (0, 1)]
        o_w = [jss.wire(x) for x in o]
        return cor_w, o_w, np.asarray(jss.verdicts(ss, field, o[0], o_w[1]))


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,budget", [(12, 1), (12, 2), (12, 4), (10, 4), (7, 4)])
def test_honest_level0_checks_match_jax_at_every_shard_count(n, budget):
    port_in, jax_in = _level0(n)
    ss, jss_b = _binds(n, budget)
    single = _port_chain(None, tf.FE62, port_in, 0)
    got = _port_chain(ss, tf.FE62, port_in, 0)
    want = _jax_chain(jss_b, jf.FE62, jax_in, 0)
    for g, s, w in zip(got[:2], single[:2], want[:2]):
        for a, b, c in zip(g, s, w):
            _same(a, np.asarray(c))
            _same(a, b)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], single[2])
    assert got[2].all()  # honest clients pass


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("k", [2, 4])
def test_random_pairs_match_jax(field, k):
    tfield, jfield = getattr(tf, field), getattr(jf, field)
    port_in, jax_in = _random(12, tfield)
    ss, jss_b = _binds(12, k)
    got = _port_chain(ss, tfield, port_in, 5)
    want = _jax_chain(jss_b, jfield, jax_in, 5)
    for g, w in zip(got[:2], want[:2]):
        for a, c in zip(g, w):
            _same(a, np.asarray(c))
    np.testing.assert_array_equal(got[2], want[2])
    assert not got[2].any()


@pytest.mark.parametrize("field", ["FE62", "F255"])
@pytest.mark.parametrize("n,budget", [(12, 1), (12, 2), (12, 4), (10, 4)])
def test_challenge_stream_parts_match_jax(field, n, budget):
    tfield, jfield = getattr(tf, field), getattr(jf, field)
    m, level = 6, 3
    ss, jss_b = _binds(n, budget)
    r, rands = tss.stream_parts(ss, tfield, SEED, level, m, n, D, "cpu")
    with torch_ref.installed():
        jr, jrands = jss.stream_parts(jss_b, jfield, SEED, level, m, n, D)
    _same(r, np.asarray(jr))
    _same(rands, np.asarray(jrands))
    wr, wrands = tsk.shared_r_stream(tfield, SEED, level, m, n * D)
    _same(rands, tsk.wire(wrands))


def test_sketch_shard_binding_degrades_and_warms():
    for n in (1, 7, 10, 12, 100000):
        for budget in range(0, 9):
            assert tss.sketch_shards(n, budget) == jss.sketch_shards(n, budget)
    assert tss.sketch_shards(100000, 4) == 4
    assert tss.bind((CPU,) * 4, 13, D, 4) is None
    ss = tss.bind((CPU,) * 4, 12, D, 3)
    assert ss.k == 3 and ss.spans() == [(0, 4), (4, 8), (8, 12)]
    for field in (tf.FE62, tf.F255):
        tss.warm_verify(ss, field, 4, 12, D, True)
        tss.warm_verify(None, field, 4, 12, D, False, "cpu")
