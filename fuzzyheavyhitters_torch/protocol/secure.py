"""Secure server-to-server data plane: the whole-level packed flow.

The port of the whole-level flow of ``fuzzyheavyhitters_tpu/protocol/
secure.py`` (``gb_step_level`` / ``ev_open_level``, secure.py:547-589), bit
for bit (ref: src/collect.rs:419-482 driving src/equalitytest.rs).  Per
level and per (node, child pattern, client) test, the two servers hold
share-bit strings that agree iff the client's ball holds the child; the
evaluator extends the Δ-OT with its strings as choices, and the garbler
answers with ONE planar message:

- S = 2·n_dims <= ``OT2S_MAX_S``: the 1-of-2^S chosen-payload table
  (``ops/otext_cuda.py``), no garbled circuit;
- otherwise (or with ``ot_path="gc"``): the packed garbled batch with the
  b2a payloads under its output labels (``ops/gc.py``, ``ops/gc_cuda.py``).

Either way the evaluator learns ``r0`` where the strings are equal, else
``r1 = r0 ± 1`` (+1 when server 0 garbles, −1 when server 1 does), so the
leader's ``v0 - v1`` over summed shares is the count whichever server
garbled.  Payloads are FE62 values (4 words) on inner levels and F255
values (8 words) on the last.  The pad index base ``idx0`` is the
extension session's pre-batch ``consumed`` counter on both sides.

``phase`` arguments take a context-manager factory ``phase(name)`` that
the driver uses to time the steps under the socket server's phase names
(``otext``, ``b2a``, ``garble``, ``eval``).

Beside the whole-level flow sit the JAX package's other sans-IO forms,
which ``parallel/mesh.py`` and the parity tests use: the two-round flow
(``ev_step1`` → ``gb_step1`` → ``ev_step2`` → ``ev_step3`` → ``gb_step2``
→ ``ev_step4``: Δ-OT labels, the garbled batch, the b2a OT under
chosen-payload pads), the test-major 1-of-2^S table (``ot2s_encrypt`` /
``ot2s_decrypt``, ``gb_step_ot4`` / ``ev_open_ot4``), the fused flat-wire
form (``gb_step_fused`` / ``ev_open_fused``) and the wire packing helpers.
Every equality test among them reaches the kernels' wrappers
(``otext_cuda``, ``gc_cuda``) at S >= 2.  ``EQ_OT4`` turns the table off
for ``ot_path="auto"``, as the JAX package's module flag does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import gc, otext, otext_cuda, prg
from ..ops.fields import F255, FE62
from ..utils import words_from_numpy, words_to_numpy

EQ_OT4: bool = True  # False: "auto" takes the garbled circuit at every S
OT2S_MAX_S = 6  # auto-path ceiling of the 1-of-2^S table (2^S ciphertexts per test)
_OT2S_DOMAIN = otext_cuda.OT2S_DOMAIN  # ot_hash tweak domain of the per-test pads
B2A_TESTS = 1 << 22  # tests per b2a pass; a multiple of 4 keeps passes block-aligned
SUM_NODES = 64  # frontier nodes per share-sum pass (bounds int64 temporaries)


def _no_phase(name: str):
    return contextlib.nullcontext()


def _string_positions(d: int) -> np.ndarray:
    """uint32[2^d, 2d] — packed-bit positions of child pattern c's compared
    string, dim-major and side-minor, at direction ``(c >> j) & 1``
    (collect.rs:393-410, lib.rs:125-129)."""
    out = np.empty((1 << d, 2 * d), np.uint32)
    for c in range(1 << d):
        k = 0
        for j in range(d):
            r = (c >> j) & 1
            for s in range(2):
                out[c, k] = j * 4 + s * 2 + r
                k += 1
    return out


def child_strings(packed: torch.Tensor, d: int) -> torch.Tensor:
    """int32[F, N] packed share bits -> bool[F, 2^d, N, 2d] strings."""
    return child_strings_radix(packed, d, 1)


def _string_positions_radix(d: int, radix: int) -> np.ndarray:
    """uint32[2^(radix·d), 2·d·radix] — packed-bit positions of fused child
    pattern c's string under the radix layout (``collect._radix_positions``):
    the step-major concatenation of the per-depth strings along c's path,
    column ``t·2d + j·2 + s`` holding dim j / side s of the depth-(t+1)
    node reached by steps 0..t.  Equality over the concatenation is the AND
    of the per-depth equalities.  ``_string_positions`` at radix 1."""
    if radix == 1:
        return _string_positions(d)
    T = (1 << (radix + 1)) - 2  # packed bits per (dim, side)
    C = 1 << (radix * d)
    out = np.empty((C, 2 * d * radix), np.uint32)
    for c in range(C):
        node = [0] * d
        k = 0
        for t in range(radix):
            base = (2 << t) - 2  # offset of depth-(t+1) nodes in the subtree
            for j in range(d):
                node[j] |= ((c >> (t * d + j)) & 1) << t
                for s in range(2):
                    out[c, k] = j * 2 * T + s * T + base + node[j]
                    k += 1
    return out


def child_strings_radix(packed: torch.Tensor, d: int, radix: int) -> torch.Tensor:
    """int32[F, N] radix-packed share bits -> bool[F, 2^(radix·d), N,
    2·d·radix] fused strings; :func:`child_strings` at radix 1."""
    pos = torch.from_numpy(_string_positions_radix(d, radix).astype(np.int32)).to(packed.device)
    return ((packed[:, None, :, None] >> pos[None, :, None, :]) & 1).to(torch.bool)


def payload_words(field) -> int:
    return 8 if field is F255 else 4


def field_to_words(field, v) -> torch.Tensor:
    b = field.to_blocks(v)
    return b.reshape(b.shape[:-2] + (8,)) if field is F255 else b


def words_to_field(field, w) -> torch.Tensor:
    if field is F255:
        return field.from_blocks(w.reshape(w.shape[:-1] + (2, 4)))
    return field.from_blocks(w)


def derive_seed(base: np.ndarray, purpose: int, level: int, ctr: int = 0) -> np.ndarray:
    """Per-(purpose, level, crawl-counter) PRG seed from a session seed."""
    s = np.array(base, np.uint32, copy=True)
    s[1] ^= np.uint32(ctr & prg.M32)
    s[2] ^= np.uint32(purpose)
    s[3] ^= np.uint32(level)
    return s


def b2a_payload_pair(field, b2a_seed, B: int, garbler: int, device):
    """The sender's b2a share pair: ``r0`` sampled from the seed's stream,
    ``r1 = r0 + 1`` when server 0 sends, ``r0 - 1`` when server 1 does.
    Returns (r1 — the sender's additive shares, w0, w1 — the payloads as
    int32[B, W] words).  Runs in passes of :data:`B2A_TESTS` tests over the
    one CTR stream."""
    W = payload_words(field)
    seed = words_from_numpy(b2a_seed, device)
    one = field.from_int(1, device)
    r1 = (torch.empty((B, 8), dtype=torch.int32, device=device) if field is F255
          else torch.empty(B, dtype=torch.int64, device=device))
    w0 = torch.empty((B, W), dtype=torch.int32, device=device)
    w1 = torch.empty_like(w0)
    for b0 in range(0, B, B2A_TESTS):
        b1 = min(B, b0 + B2A_TESTS)
        words = prg.stream_words(seed, (b1 - b0) * W, offset=b0 * W // 16)
        r0 = field.sample(words.reshape(b1 - b0, W))
        r = field.sub(r0, one) if garbler else field.add(r0, one)
        r1[b0:b1] = r
        w0[b0:b1] = field_to_words(field, r0)
        w1[b0:b1] = field_to_words(field, r)
    return r1, w0, w1


def ot_path(S: int, override: str = "auto") -> str:
    """``"ot2s"`` (the 1-of-2^S table) or ``"gc"`` (garbled circuit) for
    strings of S bits: "auto" picks ot2s for 2 <= S <= OT2S_MAX_S unless
    ``EQ_OT4`` is off; "ot2s" past the ceiling raises; "gc" forces the
    circuit."""
    if override == "gc":
        return "gc"
    if override == "ot2s":
        if S > OT2S_MAX_S:
            raise ValueError(
                f"ot_path='ot2s' forced at S={S}: the 1-of-2^S table is capped at "
                f"S={OT2S_MAX_S} (2^S ciphertexts per test) — use the GC path for "
                "wider strings")
        return "ot2s"
    if override != "auto":
        raise ValueError(f"unknown ot_path {override!r}")
    return "ot2s" if EQ_OT4 and 2 <= S <= OT2S_MAX_S else "gc"


def _ot4_use(S: int) -> bool:
    """Whether ``"auto"`` skips the garbled circuit at S (the mesh's engine
    rule: it reads ``EQ_OT4``, never a config's ``ot_path``)."""
    return ot_path(S) == "ot2s"


def ot2s_encrypt(q_rows, s_block, x_flat, m_v0, m_v1, n_words: int,
                 idx_offset: int) -> torch.Tensor:
    """Test-major sender table: q_rows int32[B, S, 4], x_flat bool[B, S],
    payloads int32[B, n_words] -> cts int32[2^S, B, n_words], slot c (the
    receiver's string as a little-endian S-bit integer) holding m_v1 where
    c = x, else m_v0, under the pad of test i at index idx_offset + i.
    One launch of the encrypt kernel over B tests with no pad tests; the
    result is a view of its planar table."""
    B, S = x_flat.shape
    cts = otext_cuda.enc_planar(q_rows, s_block, x_flat, m_v0, m_v1, idx_offset, B)
    return cts.reshape(1 << S, n_words, B).permute(0, 2, 1)


def ot2s_decrypt(t_rows, y_flat, cts, n_words: int, idx_offset: int) -> torch.Tensor:
    """Receiver open, test-major: t_rows int32[B, S, 4], y_flat bool[B, S]
    (its strings, the extension's choices), cts int32[2^S, B, n_words] at
    any strides -> int32[B, n_words] = m_{[x == y]}.  One launch of the
    decrypt kernel."""
    return otext_cuda.dec_planar(t_rows, y_flat, cts, idx_offset)


ot4_encrypt = ot2s_encrypt  # the JAX package's names, which its mesh calls
ot4_decrypt = ot2s_decrypt


def _b2a_seal(field, pad0, pad1, mask, b2a_seed, garbler: int):
    """The b2a payload pair (r0, r1 = r0 ± 1) ordered by the garbler's
    mask (slot 0 carries r0 where the mask is set, collect.rs:439-456) and
    encrypted under the pads -> (c0, c1 int32[B, W], r1)."""
    r1, w0, w1 = b2a_payload_pair(field, b2a_seed, mask.shape[0], garbler, pad0.device)
    m = mask[:, None]
    return torch.where(m, w0, w1) ^ pad0, torch.where(m, w1, w0) ^ pad1, r1


def b2a_encrypt(field, q2_rows, s_block, mask, b2a_seed, idx0: int, garbler: int = 0):
    """The b2a sender on the b2a extension's Q rows int32[B, 4]: the pair
    (r0, r1 = r0 ± 1) ordered by ``mask`` and encrypted under ``H(j, Q_j)``
    / ``H(j, Q_j ^ s)`` from index ``idx0``.  Returns (c0, c1 int32[B, W],
    r1 — the sender's additive shares)."""
    W = payload_words(field)
    pad0 = otext.ot_hash(q2_rows, W, idx0)
    pad1 = otext.ot_hash(q2_rows ^ words_from_numpy(s_block, q2_rows.device), W, idx0)
    return _b2a_seal(field, pad0, pad1, mask, b2a_seed, garbler)


def b2a_decrypt(field, t2_rows, idx0: int, c0, c1, e_bits) -> torch.Tensor:
    """The b2a receiver: open the ciphertext its choice ``e_bits`` picks
    with ``H(j, T_j)`` -> field values (r0 where equal, r1 where not)."""
    pad = otext.ot_hash(t2_rows, payload_words(field), idx0)
    return words_to_field(field, torch.where(e_bits[:, None], c1, c0) ^ pad)


def ot2s_encrypt_packed(q_rows, s_block, x_flat, m_v0, m_v1, n_words: int,
                        idx_offset: int) -> torch.Tensor:
    """Planar 1-of-2^S sender table over padded_tests(B) tests, raveled:
    q_rows int32[B, S, 4], s_block uint32[4], x_flat bool[B, S], payloads
    int32[B, n_words] (slot x gets m_v1, every other slot m_v0).  One
    launch of the encrypt kernel."""
    return otext_cuda.enc_planar(q_rows, s_block, x_flat, m_v0, m_v1, idx_offset)


def ot2s_decrypt_packed(t_rows, y_flat, msg, n_words: int, idx_offset: int) -> torch.Tensor:
    """Open the planar table with the T rows int32[B, S, 4] -> int32[B,
    n_words].  One launch of the decrypt kernel."""
    return otext_cuda.dec_planar(t_rows, y_flat, msg, idx_offset)


# ---------------------------------------------------------------------------
# The two-round flow (secure.py:163-269 of the JAX package): the evaluator's
# u message -> the garbled batch -> the b2a u message -> the ciphertext pair
# ---------------------------------------------------------------------------


def ev_step1(rcv: otext.OtExtReceiver, y_flat):
    """Evaluator: request input labels with its strings bool[B, S] as
    choices -> (u message, T rows int32[B*S, 4], its labels-to-be)."""
    B, S = y_flat.shape
    return rcv.extend(y_flat.reshape(B * S))


def gb_step1(snd: otext.OtExtSender, u_msg, x_flat, gc_seed):
    """Garbler: the evaluator's zero-labels from the extension, then the
    garbled batch -> (batch to send, mask bool[B] — its XOR shares)."""
    B, S = x_flat.shape
    q = snd.extend(B * S, u_msg)
    return gc.garble_equality_delta(snd.s_block, q.reshape(B, S, 4), gc_seed, x_flat)


def ev_step2(batch: gc.GarbledEqBatch, t_rows, B: int, S: int) -> torch.Tensor:
    """Evaluator: its labels are the T rows; evaluate -> XOR shares bool[B]."""
    return gc.eval_equality(batch, t_rows.reshape(B, S, 4))


def ev_step3(rcv: otext.OtExtReceiver, e_bits):
    """Evaluator: open the b2a OT with its XOR shares as choices -> (u
    message, T2 rows, idx0 — the pad index base)."""
    idx0 = rcv.consumed
    u2, t2 = rcv.extend(e_bits)
    return u2, t2, idx0


def gb_step2(snd: otext.OtExtSender, u2_msg, mask, b2a_seed, field, garbler: int = 0):
    """Garbler: extend the b2a OT with its pads (:meth:`OtExtSender.
    extend_pads`) and encrypt the ordered payload pair -> (c0, c1 int32[B,
    W], r1 — its additive shares); bit for bit :func:`b2a_encrypt`."""
    _, pad0, pad1 = snd.extend_pads(mask.shape[0], u2_msg, payload_words(field))
    return _b2a_seal(field, pad0, pad1, mask, b2a_seed, garbler)


def ev_step4(rcv: otext.OtExtReceiver, t2_rows, idx0: int, c0, c1, e_bits, field):
    """Evaluator: decrypt its chosen payload -> field values [B] (r0 where
    equal, r1 where not)."""
    return b2a_decrypt(field, t2_rows, idx0, c0, c1, e_bits)


def gb_step_ot4(snd: otext.OtExtSender, u_msg, x_flat, b2a_seed, field, garbler: int = 0):
    """Garbler level step on the S = 2 table: extend the Δ-OT, derive the
    b2a pair and encrypt the 1-of-4 table -> (cts int32[4, B, W], r1)."""
    B, S = x_flat.shape
    if S != 2:
        raise ValueError(f"the ot4 step is the S == 2 specialization, got S={S}")
    idx0 = snd.consumed
    q = snd.extend(B * S, u_msg)
    W = payload_words(field)
    r1, w0, w1 = b2a_payload_pair(field, b2a_seed, B, garbler, q.device)
    # result 1 (strings equal) -> the receiver learns r0 (collect.rs:439-456)
    return ot2s_encrypt(q.reshape(B, S, 4), snd.s_block, x_flat, w1, w0, W, idx0), r1


def ev_open_ot4(rcv: otext.OtExtReceiver, t_rows, y_flat, msg, B: int, field, idx0: int):
    """Receiver twin of :func:`gb_step_ot4` -> field values [B]."""
    W = payload_words(field)
    w = ot2s_decrypt(t_rows.reshape(B, 2, 4), y_flat, msg.reshape(4, B, W), W, idx0)
    return words_to_field(field, w)


def ev_step1_fused(rcv: otext.OtExtReceiver, y_flat, phase=_no_phase):
    """Evaluator: extend the Δ-OT with its strings bool[B, S] as choices ->
    (u message, T rows int32[B*S, 4], idx0 — the pre-extension counter)."""
    with phase("otext"):
        idx0 = rcv.consumed
        u, t = ev_step1(rcv, y_flat)
    return u, t, idx0


def gb_step_level(snd: otext.OtExtSender, u_msg, x_flat, gc_seed, b2a_seed, field,
                  garbler: int = 0, path: str = "auto", phase=_no_phase):
    """Garbler whole-level step: extend the Δ-OT, derive the b2a pair, and
    build the level's one planar message (table or garbled batch, by
    :func:`ot_path`).  Returns (msg int32[...], vals — the garbler's
    additive shares r1)."""
    B, S = x_flat.shape
    p = ot_path(S, path)
    W = payload_words(field)
    with phase("otext"):
        idx0 = snd.consumed
        q = snd.extend(B * S, u_msg).reshape(B, S, 4)
    with phase("b2a"):
        r1, w0, w1 = b2a_payload_pair(field, b2a_seed, B, garbler, q.device)
        # result 1 (strings equal) -> the evaluator learns r0 (collect.rs:439-456)
        if p == "ot2s":
            msg = ot2s_encrypt_packed(q, snd.s_block, x_flat, w1, w0, W, idx0)
    if p == "gc":
        with phase("garble"):
            msg, _ = gc.garble_equality_payload_packed(snd.s_block, q, gc_seed, x_flat,
                                                       w1, w0, W, idx0)
    return msg, r1


def ev_open_level(t_rows, y_flat, msg, B: int, S: int, field, idx0: int,
                  path: str = "auto", phase=_no_phase):
    """Evaluator whole-level twin: open the planar message with the Δ-OT T
    rows -> field values [B] (r0 where equal, else r1)."""
    p = ot_path(S, path)
    W = payload_words(field)
    if p == "ot2s":
        with phase("b2a"):
            return words_to_field(field, ot2s_decrypt_packed(
                t_rows.reshape(B, S, 4), y_flat, msg, W, idx0))
    with phase("eval"):
        _, w = gc.eval_equality_payload_packed(msg, t_rows.reshape(B, S, 4), W, idx0)
    with phase("b2a"):
        return words_to_field(field, w)


def gb_step_fused(snd: otext.OtExtSender, u_msg, x_flat, gc_seed, b2a_seed, field,
                  garbler: int = 0):
    """Garbler, flat-wire fused form: extend the Δ-OT, garble, and attach
    the b2a payloads under the output labels (K2) -> (packed message
    int32[...], r1)."""
    B, S = x_flat.shape
    idx0 = snd.consumed
    q = snd.extend(B * S, u_msg)
    W = payload_words(field)
    r1, w0, w1 = b2a_payload_pair(field, b2a_seed, B, garbler, q.device)
    # v = 1 (strings equal) -> the evaluator learns r0 (collect.rs:439-456)
    batch, cts, _ = gc.garble_equality_payload(snd.s_block, q.reshape(B, S, 4), gc_seed,
                                               x_flat, w1, w0, W, idx0)
    return pack_gc_payload_batch(batch, cts), r1


def ev_open_fused(rcv: otext.OtExtReceiver, t_rows, msg, B: int, S: int, field, idx0: int):
    """Evaluator twin of :func:`gb_step_fused`: evaluate, open the payload
    under the output label -> field values [B] (r0 where equal, else r1)."""
    W = payload_words(field)
    batch, cts = unpack_gc_payload_batch(msg, B, S, W)
    _, w = gc.eval_equality_payload(batch, t_rows.reshape(B, S, 4), cts, W, idx0)
    return words_to_field(field, w)


def pack_gc_batch(batch: gc.GarbledEqBatch) -> torch.Tensor:
    """A garbled batch as one int32 buffer: tables | gb_labels | decode."""
    return torch.cat([batch.tables.reshape(-1), batch.gb_labels.reshape(-1),
                      batch.decode.reshape(-1).to(torch.int32)])


def unpack_gc_batch(buf: torch.Tensor, B: int, S: int) -> gc.GarbledEqBatch:
    nt, nl = B * (S - 1) * 2 * 4, B * S * 4
    return gc.GarbledEqBatch(tables=buf[:nt].reshape(B, S - 1, 2, 4),
                             gb_labels=buf[nt:nt + nl].reshape(B, S, 4),
                             decode=buf[nt + nl:] != 0)


def pack_gc_payload_batch(batch: gc.GarbledEqBatch, cts: torch.Tensor) -> torch.Tensor:
    """:func:`pack_gc_batch` followed by the ciphertexts [2, B, W]."""
    return torch.cat([pack_gc_batch(batch), cts.reshape(-1)])


def unpack_gc_payload_batch(buf: torch.Tensor, B: int, S: int, W: int):
    base = B * (S - 1) * 2 * 4 + B * S * 4 + B
    return unpack_gc_batch(buf[:base], B, S), buf[base:].reshape(2, B, W)


def node_share_sums(field, vals, weight) -> torch.Tensor:
    """vals: field elements [F, C, N(, limbs)]; weight: bool[F, C, N] ->
    per-(node, pattern) share sums [F, C(, limbs)].  Dead clients and dead
    nodes count zero, identically on both servers (collect.rs:495)."""
    out = []
    for f0 in range(0, vals.shape[0], SUM_NODES):
        v, w = vals[f0:f0 + SUM_NODES], weight[f0:f0 + SUM_NODES]
        if field.limb_shape:
            w = w[..., None]
        out.append(field.sum(torch.where(w, v, 0), dim=2))
    return torch.cat(out)


def alive_weight(alive_nodes: torch.Tensor, alive_keys: torch.Tensor, C: int) -> torch.Tensor:
    """bool[F, C, N] gating weight from the public liveness masks."""
    return (alive_nodes[:, None, None] & alive_keys[None, None, :]).expand(
        alive_nodes.shape[0], C, alive_keys.shape[0])


_warm_pairs: dict = {}  # device -> the process's throwaway (OtExtSender, OtExtReceiver)


def _warm_pair(dev):
    if dev not in _warm_pairs:
        _warm_pairs[dev] = otext.inprocess_pair(dev)
    return _warm_pairs[dev]


def warm_level_kernels(packed, d: int, field, path: str = "auto", radix: int = 1) -> None:
    """Run one level's whole secure chain at this shape on a throwaway
    in-process OT pair, built once per process and device (the JAX
    package's ``warm_level_kernels``): strings, the Δ-OT extension, the b2a
    share pair for both garbling signs, the equality message (table or
    garbled batch, as :func:`ot_path` picks for S' = 2·d·radix), its open
    and the share sums.  The wire arrays pass through host numpy as on the
    socket path.  No live session or data plane is touched; the outputs
    are discarded."""
    dev = packed.device
    snd, rcv = _warm_pair(dev)
    strs = child_strings_radix(packed, d, radix)
    F, C, N, S = strs.shape
    B = F * C * N
    flat = strs.reshape(B, S)
    zero = np.zeros(4, np.uint32)
    gseed, bseed = derive_seed(zero, 1, 0), derive_seed(zero, 2, 0)
    u, t_rows, idx0 = ev_step1_fused(rcv, flat)
    u = words_from_numpy(words_to_numpy(u), dev)
    for g in (0, 1):  # the crawl alternates the garbler: both signs
        b2a_payload_pair(field, bseed, B, g, dev)
    msg, _ = gb_step_level(snd, u, flat, gseed, bseed, field, 0, path)
    msg = words_from_numpy(words_to_numpy(msg), dev)
    vals = ev_open_level(t_rows, flat, msg, B, S, field, idx0, path)
    w = torch.ones((F, C, N), dtype=torch.bool, device=dev)
    node_share_sums(field, vals.reshape((F, C, N) + field.limb_shape), w).cpu()


def warm_level_kernels_sharded(ks, packed, d: int, F: int, N: int, field, path: str = "auto",
                               radix: int = 1) -> None:
    """:func:`warm_level_kernels` for a row-sharded kernel level
    (``parallel/kernel_shard.py``, the JAX package's
    ``warm_level_kernels_sharded``): the per-shard strings, both roles of
    the row-sharded extension, the per-shard equality kernels at both
    garbling signs, the per-shard open and the folded share sums, on the
    process's throwaway OT pair, the u matrix and the frame through host
    numpy as on the socket path.  ``packed`` is the expansion's words,
    whole or per data shard."""
    from ..parallel import kernel_shard

    dev = ks.devices[0]
    snd, rcv = _warm_pair(dev)
    flat = kernel_shard.shard_flat(ks, packed, d, F, N, radix)
    zero = np.zeros(4, np.uint32)
    gseed, bseed = derive_seed(zero, 1, 0), derive_seed(zero, 2, 0)
    p = ot_path(2 * d * radix, path)
    vals = None
    for g in (0, 1):  # the crawl alternates the garbler: both signs
        _, _, _, vals = kernel_shard.run_level_pair(ks, snd, rcv, flat, flat, gseed, bseed,
                                                    field, g, p)
    C = 1 << (d * radix)
    w = torch.ones((F, C, N), dtype=torch.bool, device=dev)
    kernel_shard.share_sums(ks, field, vals, w, F, C, N).cpu()
