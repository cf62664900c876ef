"""The PyTorch port's garbled-circuit equality with b2a payloads
(``ops/gc.py``: the plain versions of the ``csrc/gc.cu`` kernels and the
packed entry points) against the JAX package, bit for bit, on the whole
planar message, pad slots included: S in {2, 4, 6, 8}, both payload widths,
a batch that is not a whole number of planar blocks, a non-zero pad index.
The kernels' host-built gate schedule (``gc_cuda.gate_schedule``), walked
here step by step as ``csrc/gc.cu`` walks it, gives the same planes at every
S in 2..16 and at the odd widths.

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
from fuzzyheavyhitters_torch.ops.otext import ot_hash
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


def _walk_garble(R, X0, Y0, xb, mask, mv0, mv1, idx0):
    """``csrc/gc.cu``'s garble, step by step over ``gc_cuda.gate_schedule``
    with the plain gate hash, on plane-major inputs: a gate's inputs are
    leaves (Z0 = X0 ^ Y0 ^ R of a wire, whose garbler label goes out then)
    or output slots; each of its two halves hashes a label and the label ^
    R; after the 2(S-1) gate steps one step hashes the two OT pads."""
    S, n, W = xb.shape[0], X0.shape[1], mv0.shape[0]
    Rt = _w(np.asarray(R, np.uint32))
    slots = [None] * (S // 2)  # output slot: int32[n, 4]
    tab = torch.zeros((8 * (S - 1), n), dtype=torch.int32)
    gbl = torch.zeros((4 * S, n), dtype=torch.int32)
    lsb = lambda lb: (lb[:, 0] & 1).bool()[:, None]

    def take(w, leaf):
        if not leaf:
            return slots[w]
        x = X0[4 * w:4 * w + 4].T
        gbl[4 * w:4 * w + 4] = (x ^ torch.where(xb[w][:, None] != 0, Rt, 0)).T
        return x ^ Y0[4 * w:4 * w + 4].T ^ Rt

    for g, (a, b, o, la, lb_) in enumerate(gc_cuda.gate_schedule(S).tolist()):
        A, B = take(a, la), take(b, lb_)
        for half, L in ((0, A), (1, B)):
            h0, h1 = tgc._hash_many(torch.stack([L, L ^ Rt])[:, :, None, :],
                                    torch.tensor([g]), (half, half))[:, :, 0, :]
            if half == 0:
                tg = h0 ^ h1 ^ torch.where(lsb(B), Rt, 0)
                wg = h0 ^ torch.where(lsb(A), tg, 0)
                tab[8 * g:8 * g + 4] = tg.T
            else:
                te = h0 ^ h1 ^ A
                tab[8 * g + 4:8 * g + 8] = te.T
                slots[o] = out0 = wg ^ h0 ^ torch.where(lsb(B), te ^ A, 0)
    p = lsb(out0)
    c0 = mv0.T ^ ot_hash(out0, W, idx0)
    c1 = mv1.T ^ ot_hash(out0 ^ Rt, W, idx0)
    dec = (p[:, 0].int() ^ mask[0])[None]
    cts = torch.cat([torch.where(p, c1, c0).T, torch.where(p, c0, c1).T])
    return tab, gbl, dec, cts


def _walk_eval(gbl, evl, tab, dec, cts, idx0):
    """``csrc/gc.cu``'s eval, gate by gate over the schedule (a leaf's active
    label gbl ^ evl, else an output slot), then the pad."""
    S, n, W = gbl.shape[0] // 4, gbl.shape[1], cts.shape[0] // 2
    slots = [None] * (S // 2)
    lsb = lambda lb: (lb[:, 0] & 1).bool()[:, None]
    take = lambda w, leaf: (gbl ^ evl)[4 * w:4 * w + 4].T if leaf else slots[w]
    for g, (a, b, o, la, lb_) in enumerate(gc_cuda.gate_schedule(S).tolist()):
        A, B = take(a, la), take(b, lb_)
        ha, hb = tgc._hash_many(torch.stack([A, B])[:, :, None, :], torch.tensor([g]),
                                (0, 1))[:, :, 0, :]
        tg, te = tab[8 * g:8 * g + 4].T, tab[8 * g + 4:8 * g + 8].T
        slots[o] = out = (ha ^ torch.where(lsb(A), tg, 0)
                          ^ hb ^ torch.where(lsb(B), te ^ A, 0))
    sb = lsb(out)
    ct = torch.where(sb, cts[W:].T, cts[:W].T)
    return (sb[:, 0].int() ^ dec[0])[None], (ct ^ ot_hash(out, W, idx0)).T


def test_gate_schedule_is_the_tree_in_gate_order():
    """Each layer pairs the live wires in order and carries a leftover
    wire; every wire is read once as a leaf, every output but the last once
    from its slot; S // 2 slots suffice and the last gate's is the output."""
    assert gc_cuda.gate_schedule(2).tolist() == [[0, 1, 0, 1, 1]]
    assert gc_cuda.gate_schedule(5).tolist() == [[0, 1, 0, 1, 1], [2, 3, 1, 1, 1],
                                                 [0, 1, 0, 0, 0], [0, 4, 0, 0, 1]]
    for S in gc_cuda.KERNEL_S:
        sch = gc_cuda.gate_schedule(S).astype(int)
        assert sch.shape == (S - 1, 5) and sch[:, 2].max() < S // 2
        leaves = sorted(w for g in sch for w, leaf in ((g[0], g[3]), (g[1], g[4])) if leaf)
        assert leaves == list(range(S))
        assert sum(1 - g[3] + 1 - g[4] for g in sch) == S - 2
    assert gc_cuda.KERNEL_S == tuple(range(2, 17)) and gc_cuda.KERNEL_W == (4, 8)


# the widths whose JAX Pallas kernels this file also runs eagerly here (the
# walk at S <= 8 meets them through the plain versions, which
# test_packed_garble_and_eval_match_jax holds against them; a kernel body
# walked op by op takes 10-25 s a call at S >= 10)
PALLAS_WIDTHS = {(3, 8), (16, 4)}


@pytest.mark.parametrize("S", list(range(2, 17, 2)) + [3, 5])
@pytest.mark.parametrize("W", [4, 8])
def test_schedule_walk_matches_plain_and_jax(S, W):
    """The kernels' walk of the host-built schedule gives the plain
    versions' planes bit for bit, and the JAX package's packed message and
    opened payloads: its XLA twins at every width, its Pallas kernels run
    eagerly at PALLAS_WIDTHS.  Tests are independent, so the walk runs on
    the B real tests and meets the message's first B columns."""
    rng = np.random.default_rng(700 + 10 * S + W)
    B, idx0 = 700, 2**32 - 300  # the pad index wraps at test 300
    R = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    R[0] |= 1
    Y0 = rng.integers(0, 2**32, size=(B, S, 4), dtype=np.uint32)
    seed = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    x = rng.integers(0, 2, size=(B, S)).astype(bool)
    m0, m1 = (rng.integers(0, 2**32, size=(B, W), dtype=np.uint32) for _ in range(2))
    _, (X0,), mask = tgc._carve_label_words(_w(seed), B, S, 1, with_r=False)
    args = tuple(tgc.planarize(a, B) for a in (X0, _w(Y0), torch.from_numpy(x), mask, _w(m0),
                                               _w(m1)))
    walked = _walk_garble(R.tolist(), *args, idx0)
    plain = tgc.garble_planar_plain(R.tolist(), *args, idx0)
    for got, want in zip(walked, plain, strict=True):
        assert torch.equal(got, want)
    pallas = (S, W) in PALLAS_WIDTHS
    with torch_ref.installed():
        jmsg, _ = jgc._garble_equality_payload_packed_xla(R, Y0, seed, x, m0, m1, W, idx0)
        msgs = [np.asarray(jmsg, np.uint32)]
        if pallas:
            with torch_ref.pallas_eager():
                msgs.append(np.asarray(jgc_pallas.garble_equality_payload_packed(
                    R, Y0, seed, x, m0, m1, W, idx0)[0], np.uint32))
    mine = words_to_numpy(torch.cat(walked))
    for msg in msgs:
        np.testing.assert_array_equal(mine, msg.reshape(-1, tgc.padded_tests(B))[:, :B])
    y = x.copy()
    y[::3] = ~y[::3]
    evl = Y0 ^ (y[..., None] * R)
    tab, gbl, dec, cts = walked
    ev_args = (gbl, tgc.planarize(_w(evl), B), tab, dec, cts)
    e, pay = _walk_eval(*ev_args, idx0)
    pe_, ppay_ = tgc.eval_planar_plain(*ev_args, idx0)
    assert torch.equal(e, pe_) and torch.equal(pay, ppay_)
    with torch_ref.installed():
        opened = [jgc._eval_equality_payload_packed_xla(jmsg, evl, S, W, idx0)]
        if pallas:
            with torch_ref.pallas_eager():
                opened.append(jgc_pallas.eval_equality_payload_packed(jmsg, evl, W, idx0))
    for want_e, want_pay in opened:
        np.testing.assert_array_equal(e[0].numpy() != 0, np.asarray(want_e))
        np.testing.assert_array_equal(words_to_numpy(pay.T), np.asarray(want_pay, np.uint32))
