"""Garbled-circuit equality tests with b2a payloads, as plain PyTorch.

The port of ``fuzzyheavyhitters_tpu/ops/gc.py`` for the whole-level
packed flow, bit for bit (ref: src/equalitytest.rs:25-191):

- free-XOR with offset R (lsb(R) = 1): XNOR(x_i, y_i) is the relabel
  ``Z0_i = X0_i ^ Y0_i ^ R``;
- half-gates AND (Zahur-Rosulek-Evans), two table rows per gate, hashed
  with the fixed-key ChaCha ``H(label ^ (gate id, half, TWEAK2, TWEAK3))``;
  the S-leaf tree pairs wires (0,1), (2,3), ... and carries the gate
  outputs, then any leftover wire, to the next layer;
- the garbler's random mask folds into the output decode bit, and the b2a
  payloads travel under the two output labels (OT-domain pads
  ``ot_hash(out0 [^ R], idx)``), ordered by lsb(out0).

The wire is the planar plane stack of the JAX package's ``gc_pallas``:
``tables | gb_labels | decode | cts`` planes, each ``padded_tests(B)``
int32 words, pad tests garbled from zero inputs like real ones.  The kernels
(``ops/gc_cuda.py``, ``csrc/gc.cu``) compute the planes on a card; their
plain versions, :func:`garble_planar_plain` / :func:`eval_planar_plain`
(the JAX package's ``_garble_packed_planes_xla`` and the packed eval twin),
run on the CPU.

The test-major surface (a :class:`GarbledEqBatch`, ciphertexts
``[2, B, W]``) serves the two-round flows: :func:`garble_equality` (every
label from a seed), :func:`garble_equality_delta` / :func:`eval_equality`
(evaluator labels from the Δ-OT, no payloads) and the payload pair
:func:`garble_equality_payload` / :func:`eval_equality_payload`.  At S >= 2
the last four planarize their inputs (B tests, no pad slots), call the
kernels' wrappers and unplanarize, so they run the kernels on a card; the
delta pair passes zero payloads at W = 4 (the kernels are compiled for
W in {4, 8}) and drops the ciphertexts.  S < 2 takes the plain forms
(:func:`_garble_equality_payload_plain`, :func:`_eval_equality_payload_plain`,
the JAX package's XLA twins), as that package's dispatcher does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prg
from .otext import ot_hash
from ..utils import words_from_numpy

PLANAR_BLOCK = 8 * 8 * 128  # the JAX package's R_BLK * SUB * LANES tests

# hash-tweak constants (words 2/3 of the tweak block)
_TWEAK2 = 0x9E3779B9
_TWEAK3 = 0x7F4A7C15


def padded_tests(B: int) -> int:
    """Tests per planar message: B rounded up to whole planar blocks (a
    deterministic function of B, so both servers agree on sizes)."""
    return B + (-B) % PLANAR_BLOCK


def packed_msg_words(B: int, S: int, W: int) -> int:
    """int32 words of one packed garbled message."""
    return ((S - 1) * 8 + 4 * S + 1 + 2 * W) * padded_tests(B)


def planarize(a: torch.Tensor, bp: int) -> torch.Tensor:
    """[B, ...trailing] -> plane-major int32[prod(trailing), bp], zero-padded
    (``gc_pallas._planarize`` without the TPU tiling, which is a reshape)."""
    B = a.shape[0]
    k = int(np.prod(a.shape[1:])) if a.dim() > 1 else 1
    out = torch.zeros((k, bp), dtype=torch.int32, device=a.device)
    out[:, :B] = a.reshape(B, k).T.to(torch.int32)
    return out


def unplanarize(planes: torch.Tensor, B: int) -> torch.Tensor:
    """plane-major [k, bp] -> test-major [B, k]."""
    return planes[:, :B].T


def _hash_many(labels: torch.Tensor, gate_ids: torch.Tensor, halves) -> torch.Tensor:
    """H(label, tweak) over m stacked label sets int32[m, ..., k, 4]:
    tweak = (gate id, half selector of the set, TWEAK2, TWEAK3)."""
    lab = prg.to_u64(labels)
    g = gate_ids.to(torch.int64)  # [k], right-aligned against [..., k]
    h = torch.tensor(halves, dtype=torch.int64, device=labels.device).reshape(
        (len(halves),) + (1,) * (labels.dim() - 2))
    blk = [lab[..., 0] ^ g, lab[..., 1] ^ h, lab[..., 2] ^ _TWEAK2, lab[..., 3] ^ _TWEAK3]
    return prg.to_i32(torch.stack(prg.chacha_words(blk)[:4], dim=-1))


def _maskw(bit: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """bit ? block : 0 over the trailing word axis."""
    return torch.where(bit[..., None], block, 0)


def _lsb(label: torch.Tensor) -> torch.Tensor:
    return (label[..., 0] & 1).to(torch.bool)


class GarbledEqBatch(NamedTuple):
    """tables int32[B, S-1, 2, 4] (T_G, T_E per gate, tree order);
    gb_labels int32[B, S, 4]; decode bool[B] (pre-XORed with the mask)."""

    tables: torch.Tensor
    gb_labels: torch.Tensor
    decode: torch.Tensor


def _and_tree_garble(wires0: torch.Tensor, R: torch.Tensor):
    """AND-reduce zero-labels [B, S, 4] -> (out0 [B, 4], tables [B, S-1, 2, 4])."""
    tables, gate = [], 0
    Rb = R[..., None, :]
    while wires0.shape[-2] > 1:
        k = wires0.shape[-2] // 2
        A0, B0 = wires0[..., 0:2 * k:2, :], wires0[..., 1:2 * k:2, :]
        gids = torch.arange(gate, gate + k, device=wires0.device)
        pa, pb = _lsb(A0), _lsb(B0)
        HA0, HA1, HB0, HB1 = _hash_many(
            torch.stack([A0, A0 ^ Rb, B0, B0 ^ Rb]), gids, (0, 0, 1, 1))
        TG = HA0 ^ HA1 ^ _maskw(pb, Rb.expand_as(A0))
        WG = HA0 ^ _maskw(pa, TG)
        TE = HB0 ^ HB1 ^ A0
        WE = HB0 ^ _maskw(pb, TE ^ A0)
        tables.append(torch.stack([TG, TE], dim=-2))  # [B, k, 2, 4]
        gate += k
        wires0 = torch.cat([WG ^ WE, wires0[..., 2 * k:, :]], dim=-2)
    if not tables:  # S == 1: a bare XNOR, no AND gates
        tables = [wires0.new_zeros(wires0.shape[:-2] + (0, 2, 4))]
    return wires0[..., 0, :], torch.cat(tables, dim=-3)


def _and_tree_eval(wires: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Evaluator twin of :func:`_and_tree_garble` on active labels."""
    gate = 0
    while wires.shape[-2] > 1:
        k = wires.shape[-2] // 2
        A, B = wires[..., 0:2 * k:2, :], wires[..., 1:2 * k:2, :]
        gids = torch.arange(gate, gate + k, device=wires.device)
        TG = tables[..., gate:gate + k, 0, :]
        TE = tables[..., gate:gate + k, 1, :]
        HA, HB = _hash_many(torch.stack([A, B]), gids, (0, 1))
        C = (HA ^ _maskw(_lsb(A), TG)) ^ (HB ^ _maskw(_lsb(B), TE ^ A))
        gate += k
        wires = torch.cat([C, wires[..., 2 * k:, :]], dim=-2)
    return wires[..., 0, :]


class GarblerSecrets(NamedTuple):
    """The garbler's output share and the evaluator's label pairs, for an
    explicit label OT (choice bit = the evaluator's input bit)."""

    mask: torch.Tensor  # bool[B]
    ev_label0: torch.Tensor  # int32[B, S, 4], labels for y_i = 0
    ev_label1: torch.Tensor  # int32[B, S, 4], labels for y_i = 1


def _carve_label_words(seed: torch.Tensor, B: int, S: int, n_label_sets: int,
                       with_r: bool):
    """Draw [optional R] + ``n_label_sets`` [B, S, 4] label sets + B mask
    bits from the seed's CTR stream (the garbler's randomness)."""
    r_words = 4 if with_r else 0
    n_words = r_words + n_label_sets * B * S * 4 + (B + 31) // 32
    words = prg.stream_words(seed, n_words)
    R = None
    if with_r:
        R = words[:4].clone()
        R[0] |= 1  # lsb(R) = 1
    sets = [words[r_words + k * B * S * 4: r_words + (k + 1) * B * S * 4].reshape(B, S, 4)
            for k in range(n_label_sets)]
    mask_words = words[r_words + n_label_sets * B * S * 4:]
    i = torch.arange(B, device=seed.device)
    mask = ((mask_words[i // 32] >> (i % 32).to(torch.int32)) & 1).to(torch.bool)
    return R, sets, mask


def _carve_label_words_shard(seed: torch.Tensor, B: int, S: int, t0: int, bloc: int):
    """Tests ``[t0, t0 + bloc)`` of the single-set draw (``with_r`` False) of
    :func:`_carve_label_words`, without the rest of the stream: the
    row-sharded kernel stage's slice of the garbler's labels and mask bits
    (``parallel/kernel_shard.py``).  The label region seeks to block
    ``t0·S·4/16``, the mask region (from word ``M0 = B·S·4``) to block
    ``(M0 - M0 % 16)/16 + t0/512`` with ``M0 % 16`` words to skip; both
    seeks are Python ints, so no product wraps at 32 bits (the JAX package
    computes them in int64).  ``t0`` is a multiple of 512.  Tests at or
    past ``B`` carve to zero, as the whole draw's planar padding does.
    Returns (X0 int32[bloc, S, 4], mask bool[bloc])."""
    dev = seed.device
    live = torch.arange(t0, t0 + bloc, device=dev) < B
    X0 = prg.stream_blocks(seed, bloc * S * 4 // 16, t0 * S * 4 // 16).reshape(bloc, S, 4)
    X0 = torch.where(live[:, None, None], X0, 0)
    m0 = B * S * 4
    intra = m0 % 16
    cw = (bloc + 31) // 32
    nb = -(-(intra + cw) // 16)
    words = prg.stream_blocks(seed, nb, (m0 - intra) // 16 + t0 // 512).reshape(nb * 16)
    words = words[intra:intra + cw]
    i = torch.arange(bloc, device=dev)
    mask = ((words[i // 32] >> (i % 32).to(torch.int32)) & 1).to(torch.bool)
    return X0, mask & live


def _garble_core(R, X0, Y0, mask, x_bits):
    """Labels + offset -> (batch, output zero-labels out0)."""
    B = x_bits.shape[0]
    Z0 = X0 ^ Y0 ^ R  # XNOR relabel (free)
    out0, tables = _and_tree_garble(Z0, R.expand(B, 4))
    decode = _lsb(out0) ^ mask
    gb_labels = X0 ^ _maskw(x_bits, R.expand_as(X0))
    return GarbledEqBatch(tables=tables, gb_labels=gb_labels, decode=decode), out0


def _garble_payload(R, X0, Y0, mask, x_bits, m_v0, m_v1, n_words: int, idx0: int):
    """:func:`_garble_core` with the payloads under the output labels ->
    (batch, cts int32[2, B, n_words] indexed by the v = 0 label's lsb):
    m_v0 / m_v1 under ``ot_hash(out0 [^ R], idx0 + i)``."""
    batch, out0 = _garble_core(R, X0, Y0, mask, x_bits)
    c_v0 = m_v0 ^ ot_hash(out0, n_words, idx0)
    c_v1 = m_v1 ^ ot_hash(out0 ^ R, n_words, idx0)
    p = _lsb(out0)[:, None]
    return batch, torch.stack([torch.where(p, c_v1, c_v0), torch.where(p, c_v0, c_v1)])


def _eval_equality_payload_plain(batch: GarbledEqBatch, ev_labels, cts, n_words: int,
                                 idx_offset: int):
    """Evaluate and open the payload under the output label, test-major
    (the JAX package's ``_eval_equality_payload_xla``; the plain twin of
    :func:`eval_equality_payload`) -> (e bool[B], payload int32[B, n_words])."""
    out = _and_tree_eval(batch.gb_labels ^ ev_labels, batch.tables)
    s = _lsb(out)
    ct = torch.where(s[:, None], cts[1], cts[0])
    return s ^ batch.decode, ct ^ ot_hash(out, n_words, idx_offset)


def garble_planar_plain(R, X0, Y0, xb, mask, mv0, mv1, idx0: int):
    """Plain version of the garble kernel on plane-major inputs over n tests:
    R 4 uint32 values, X0/Y0 int32[4S, n], xb int32[S, n] 0/1, mask
    int32[1, n] 0/1, mv0/mv1 int32[W, n]; test i's pad index is idx0 + i.
    Returns (tables [8(S-1), n], gb_labels [4S, n], decode [1, n],
    cts [2W, n]) — ``_garble_packed_planes_xla`` of the JAX package."""
    n = X0.shape[1]
    S, W = xb.shape[0], mv0.shape[0]
    Rt = words_from_numpy(np.asarray(R, np.uint32), X0.device)
    lab = lambda p: unplanarize(p, n).reshape(n, S, 4)
    batch, cts = _garble_payload(Rt, lab(X0), lab(Y0), unplanarize(mask, n)[:, 0] != 0,
                                 unplanarize(xb, n) != 0, unplanarize(mv0, n),
                                 unplanarize(mv1, n), W, idx0)
    return (planarize(batch.tables, n), planarize(batch.gb_labels, n),
            planarize(batch.decode, n), planarize(cts.permute(1, 0, 2), n))


def eval_planar_plain(gbl, evl, tab, dec, cts, idx0: int):
    """Plain version of the eval kernel on plane-major inputs over n tests:
    -> (e [1, n] the evaluator's XOR share, pay [W, n] the opened payload)."""
    n = gbl.shape[1]
    S, W = gbl.shape[0] // 4, cts.shape[0] // 2
    batch = GarbledEqBatch(tables=unplanarize(tab, n).reshape(n, S - 1, 2, 4),
                           gb_labels=unplanarize(gbl, n).reshape(n, S, 4),
                           decode=unplanarize(dec, n)[:, 0] != 0)
    e, pay = _eval_equality_payload_plain(batch, unplanarize(evl, n).reshape(n, S, 4),
                                          unplanarize(cts, n).reshape(n, 2, W).permute(1, 0, 2),
                                          W, idx0)
    return planarize(e, n), planarize(pay, n)


def _split_packed(msg: torch.Tensor, B: int, S: int, W: int):
    """Packed wire buffer -> (tables, gb_labels, decode, cts) plane stacks."""
    bp = padded_tests(B)
    parts, base = [], 0
    for k in ((S - 1) * 8, 4 * S, 1, 2 * W):
        parts.append(msg[base:base + k * bp].reshape(k, bp))
        base += k * bp
    return parts


def garble_equality_payload_packed(R, Y0, seed, x_bits, m_v0, m_v1, n_words: int,
                                   idx_offset: int):
    """Whole-level packed garble: R uint32[4] (the OT sender's ``s``), Y0
    int32[B, S, 4] (the Δ-OT Q rows), seed uint32[4], x_bits bool[B, S],
    payloads int32[B, n_words].  The garbler's labels and mask come from the
    seed's stream for the real B tests; pad tests garble from zeros.
    Returns (msg int32[packed_msg_words], mask bool[B])."""
    from . import gc_cuda

    B, S = x_bits.shape
    if S < 2:
        raise ValueError("the packed garbled batch needs S >= 2 string bits")
    bp = padded_tests(B)
    dev = Y0.device
    _, (X0,), mask = _carve_label_words(words_from_numpy(seed, dev), B, S, 1, with_r=False)
    planes = gc_cuda.garble_planar(
        [int(r) for r in np.asarray(R, np.uint32)], planarize(X0, bp), planarize(Y0, bp),
        planarize(x_bits, bp), planarize(mask, bp), planarize(m_v0, bp),
        planarize(m_v1, bp), idx_offset)
    return torch.cat([p.reshape(-1) for p in planes]), mask


def eval_equality_payload_packed(msg, ev_labels, n_words: int, idx_offset: int):
    """Evaluate the packed batch with the evaluator's labels int32[B, S, 4]
    -> (e bool[B], payload int32[B, n_words])."""
    from . import gc_cuda

    B, S = ev_labels.shape[:2]
    if S < 2:
        raise ValueError("the packed garbled batch needs S >= 2 string bits")
    tab, gbl, dec, cts = _split_packed(msg, B, S, n_words)
    e, pay = gc_cuda.eval_planar(gbl, planarize(ev_labels, padded_tests(B)), tab, dec,
                                 cts, idx_offset)
    return unplanarize(e, B)[:, 0] != 0, unplanarize(pay, B)


# ---------------------------------------------------------------------------
# Test-major surface: the two-round flows (gc.py:256-391 of the JAX package)
# ---------------------------------------------------------------------------


def garble_equality(seed, x_bits: torch.Tensor):
    """Garble B equality tests with every label drawn from ``seed``
    (uint32[4]): R, X0, Y0 and the masks.  Returns (batch,
    :class:`GarblerSecrets`); ``mask ^ decoded == [x == y]``."""
    B, S = x_bits.shape
    R, (X0, Y0), mask = _carve_label_words(words_from_numpy(seed, x_bits.device), B, S, 2,
                                           with_r=True)
    batch, _ = _garble_core(R, X0, Y0, mask, x_bits)
    return batch, GarblerSecrets(mask=mask, ev_label0=Y0, ev_label1=Y0 ^ R)


def garble_equality_delta(R, Y0: torch.Tensor, seed, x_bits: torch.Tensor):
    """Garble with the Δ-OT's labels: R uint32[4] (the OT sender's ``s``,
    lsb 1), Y0 int32[B, S, 4] (the Q rows), seed uint32[4] for the
    garbler's own labels and masks, x_bits bool[B, S].  Returns (batch,
    mask bool[B] — the garbler's XOR share).  At S >= 2 through the garble
    kernel with zero payloads (its ciphertexts dropped)."""
    B, S = x_bits.shape
    if S >= 2:
        zero = torch.zeros((B, 4), dtype=torch.int32, device=Y0.device)
        batch, _, mask = garble_equality_payload(R, Y0, seed, x_bits, zero, zero, 4, 0)
        return batch, mask
    _, (X0,), mask = _carve_label_words(words_from_numpy(seed, Y0.device), B, S, 1,
                                        with_r=False)
    batch, _ = _garble_core(words_from_numpy(R, Y0.device), X0, Y0, mask, x_bits)
    return batch, mask


def eval_equality(batch: GarbledEqBatch, ev_labels: torch.Tensor) -> torch.Tensor:
    """Evaluate with the evaluator's labels int32[B, S, 4] -> bool[B], its
    XOR share of each result.  At S >= 2 through the eval kernel with zero
    ciphertexts (its opened payload dropped)."""
    B, S = ev_labels.shape[:2]
    if S >= 2:
        zero = torch.zeros((2, B, 4), dtype=torch.int32, device=ev_labels.device)
        return eval_equality_payload(batch, ev_labels, zero, 4, 0)[0]
    out = _and_tree_eval(batch.gb_labels ^ ev_labels, batch.tables)
    return _lsb(out) ^ batch.decode


def garble_equality_payload(R, Y0: torch.Tensor, seed, x_bits: torch.Tensor, m_v0, m_v1,
                            n_words: int, idx_offset: int):
    """:func:`garble_equality_delta` with the b2a payloads under the output
    labels (m_v0 / m_v1 int32[B, n_words]: what the evaluator learns when
    the output is 0 / 1, under ``ot_hash(label, idx_offset + i)``).
    Returns (batch, cts int32[2, B, n_words] indexed by the label's lsb,
    mask bool[B]).  At S >= 2 the garble kernel's wrapper on planar inputs
    (``gc_pallas.garble_equality_payload``'s route); S < 2 the plain form."""
    B, S = x_bits.shape
    if S < 2:
        return _garble_equality_payload_plain(R, Y0, seed, x_bits, m_v0, m_v1, n_words,
                                              idx_offset)
    from . import gc_cuda

    _, (X0,), mask = _carve_label_words(words_from_numpy(seed, Y0.device), B, S, 1,
                                        with_r=False)
    tab, gbl, dec, cts = gc_cuda.garble_planar(
        [int(r) for r in np.asarray(R, np.uint32)], planarize(X0, B), planarize(Y0, B),
        planarize(x_bits, B), planarize(mask, B), planarize(m_v0, B), planarize(m_v1, B),
        idx_offset)
    batch = GarbledEqBatch(tables=unplanarize(tab, B).reshape(B, S - 1, 2, 4),
                           gb_labels=unplanarize(gbl, B).reshape(B, S, 4),
                           decode=unplanarize(dec, B)[:, 0] != 0)
    return batch, unplanarize(cts, B).reshape(B, 2, n_words).permute(1, 0, 2), mask


def eval_equality_payload(batch: GarbledEqBatch, ev_labels: torch.Tensor, cts,
                          n_words: int, idx_offset: int):
    """Evaluate and open the output-label payload: -> (e bool[B], the
    evaluator's XOR share; payload int32[B, n_words]).  At S >= 2 the eval
    kernel's wrapper on planar inputs; S < 2 the plain form."""
    B, S = ev_labels.shape[:2]
    if S < 2:
        return _eval_equality_payload_plain(batch, ev_labels, cts, n_words, idx_offset)
    from . import gc_cuda

    e, pay = gc_cuda.eval_planar(planarize(batch.gb_labels, B), planarize(ev_labels, B),
                                 planarize(batch.tables, B), planarize(batch.decode, B),
                                 planarize(cts.permute(1, 0, 2), B), idx_offset)
    return unplanarize(e, B)[:, 0] != 0, unplanarize(pay, B)


def _garble_equality_payload_plain(R, Y0, seed, x_bits, m_v0, m_v1, n_words: int,
                                   idx_offset: int):
    """Plain twin of :func:`garble_equality_payload` (the JAX package's
    ``_garble_equality_payload_xla``), test-major throughout."""
    B, S = x_bits.shape
    dev = Y0.device
    _, (X0,), mask = _carve_label_words(words_from_numpy(seed, dev), B, S, 1, with_r=False)
    batch, cts = _garble_payload(words_from_numpy(R, dev), X0, Y0, mask, x_bits, m_v0, m_v1,
                                 n_words, idx_offset)
    return batch, cts, mask
