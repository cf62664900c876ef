"""The frozen kernel work counts reproduce the bounds PERF.md's kernel
table was measured against, and read the same shapes from a call."""

from __future__ import annotations

import pytest
import torch

from fhhbench.roofline import bound_s, expand, gc_eval, gc_garble, keygen, ot2s_decrypt, ot2s_encrypt


@pytest.mark.parametrize("work,want_ms", [
    (keygen.count(393_216, 512), 4.814),  # all of config 4's keys
    (expand.count(256 * 196_608, 196_608, 2, True, True), 1.595),  # widest level, child cache
    (ot2s_encrypt.count(2, 4, 4_194_304, 4_194_304), 0.2006),
    (ot2s_decrypt.count(2, 4, 4_194_304), 0.0826),
    (gc_garble.count(4, 4, 16_777_216), 2.808),
    (gc_eval.count(4, 4, 16_777_216), 1.404),
], ids=["keygen", "expand", "ot2s_encrypt", "ot2s_decrypt", "gc_garble", "gc_eval"])
def test_bound_ms(work, want_ms):
    digits = len(str(want_ms).split(".")[1])
    assert round(bound_s(*work) * 1e3, digits) == want_ms


def z(*shape, dtype=torch.int32):
    return torch.zeros(shape, dtype=dtype)


def test_work_reads_the_call():
    K, L = 6, 16
    assert keygen.work((z(K, 2, 4), z(K, L, dtype=torch.bool), z(K, dtype=torch.bool)), {},
                       None) == keygen.count(K, L)
    d2, N, F = 4, 5, 3
    args = (z(4, d2, F * N), z(d2, F * N, dtype=torch.bool), z(d2, F * N, dtype=torch.bool),
            z(4, d2, N), z(d2, N, dtype=torch.uint8), True)
    assert expand.work(args, {}, (None, z(1), z(1))) == expand.count(F * N, N, d2, True, True)
    assert expand.work(args[:5], {"derived_bits": False}, (None, None, None)) == \
        expand.count(F * N, N, d2, False, False)
    B, S, W, bp = 10, 4, 8, 16
    enc = (z(B, S, 4), None, z(B, S, dtype=torch.bool), z(B, W), z(B, W), 0)
    assert ot2s_encrypt.work(enc, {}, z((1 << S) * W * bp)) == ot2s_encrypt.count(S, W, bp, B)
    dec = (z(B, S, 4), z(B, S, dtype=torch.bool), z(1), 0)
    assert ot2s_decrypt.work(dec, {}, z(B, W)) == ot2s_decrypt.count(S, W, B)
    garble = (None, z(4 * S, bp), z(4 * S, bp), z(S, bp), z(1, bp), z(W, bp), z(W, bp), 0)
    assert gc_garble.work(garble, {}, None) == gc_garble.count(S, W, bp)
    ev = (z(4 * S, bp), z(4 * S, bp), z(8 * (S - 1), bp), z(1, bp), z(2 * W, bp), 0)
    assert gc_eval.work(ev, {}, None) == gc_eval.count(S, W, bp)
