"""Row-sharded secure kernel stage: the IKNP extension and the 1-of-2^S
table or garbled circuit per data shard, with a byte-identical wire (the
port of ``fuzzyheavyhitters_tpu/parallel/kernel_shard.py``).

A sharded server's whole-level planar test batch splits along its test
axis into k parts of whole planar blocks (:data:`BLOCK` = 8,192 tests), so
each shard's slice of every wire plane is contiguous:

- the extension row-shards with it: the column PRG streams are CTR-mode
  and the packed transpose is word-local, so shard j computes OT rows
  ``[t0·S, (t0 + bloc)·S)`` from the seeds and its slice of the u columns
  (``otext.sender_extend_rows`` / ``receiver_extend_rows``), the rows a
  whole-level extend gives there;
- every per-test stream draw seeks to its shard's slice of the level's
  stream (the b2a payload pair from block ``t0·W/16``, the garbler's labels
  and mask bits through ``gc._carve_label_words_shard``) and every pad
  index enters as ``idx0 + t0`` (mod 2^32), so each shard's kernel output
  is its slice of the whole-level planes;
- rows at or past the real batch B are zeroed before anything reaches the
  wire (the sender's Q rows, the payload words, the garbler's labels and
  mask), as the whole level's planar padding is;
- each shard calls the kernels' wrappers on its own tensors: the ot2s
  entries ``otext_cuda.enc_planar`` / ``dec_planar`` on the test-major
  rows (one launch a shard and step) and the GC entries
  ``gc_cuda.garble_planar`` / ``eval_planar``, which launch on a card
  shard and run their plain versions on a CPU shard;
- the sender's frame and the receiver's u matrix read back per shard
  into pinned host buffers and are assembled by position
  (:func:`assemble`); the share sums fold over shards with
  ``parallel.mesh.field_psum``.

The active shard count is the largest divisor of the level's planar block
count within the budget (``Config.secure_kernel_shards``, 0 = the data
shards), so a batch that does not divide degrades to fewer shards, down
to the single-device gather path at k = 1 (:func:`bind` None).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import gc, gc_cuda, otext, otext_cuda, prg
from ..protocol import secure
from ..utils import words_from_numpy
from .mesh import field_psum
from .server_mesh import Sharded, _largest_divisor_leq

BLOCK = gc.PLANAR_BLOCK  # tests per shard unit: one planar block


def kernel_shards(B: int, budget: int) -> int:
    """Active kernel shards of a ``B``-test level under a device
    ``budget``: the largest divisor of its planar block count within it
    (1 = the single-device gather path)."""
    return _largest_divisor_leq(gc.padded_tests(B) // BLOCK, max(1, int(budget)))


def n_msg_planes(path: str, S: int, W: int) -> int:
    """Planes (each ``padded_tests`` words) of one whole-level message:
    the 1-of-2^S table, or the garbled batch (tables | gb_labels | decode
    | cts)."""
    if path == "ot2s":
        return (1 << S) * W
    return (S - 1) * 8 + 4 * S + 1 + 2 * W


@dataclass(frozen=True)
class KernelShard:
    """One level's kernel-stage binding: ``k`` devices, ``B`` real tests of
    ``S`` bits on a ``bp``-test planar frame."""

    devices: tuple
    B: int
    S: int

    @property
    def k(self) -> int:
        return len(self.devices)

    @property
    def bp(self) -> int:
        return gc.padded_tests(self.B)

    @property
    def bloc(self) -> int:
        """Tests per shard (whole planar blocks)."""
        return self.bp // self.k


def bind(devices, B: int, S: int, budget: int) -> KernelShard | None:
    """Bind a ``B``-test level to the leading ``devices``; None when only
    one shard fits."""
    k = kernel_shards(B, min(int(budget), len(devices)))
    if k < 2:
        return None
    return KernelShard(devices=tuple(devices[:k]), B=B, S=S)


def shard_flat(ks: KernelShard, packed, d: int, F: int, N: int, radix: int = 1) -> Sharded:
    """The level's share-bit strings in the whole-level test order (F, C,
    N), one slice of ``bloc`` tests per kernel shard: bool[bloc, S'] on
    the shard's device, zero past B.  ``packed`` is the expansion's
    int32[F, N] words, whole or as the data shards' client spans; each
    kernel shard gathers only the node rows its tests touch."""
    parts = packed if isinstance(packed, list) else [packed]
    C, S = 1 << (d * radix), 2 * d * radix
    pos = torch.from_numpy(secure._string_positions_radix(d, radix).astype(np.int32))
    out = []
    for j, dev in enumerate(ks.devices):
        t0 = j * ks.bloc
        t1 = min(t0 + ks.bloc, ks.B)
        flat = torch.zeros((ks.bloc, S), dtype=torch.bool, device=dev)
        if t1 > t0:
            f_lo, f_hi = t0 // (C * N), (t1 - 1) // (C * N) + 1
            rows = torch.cat([p[f_lo:f_hi].to(dev) for p in parts], dim=1)  # [nf, N]
            t = torch.arange(t0, t1, device=dev)
            w = rows[t // (C * N) - f_lo, t % N]
            flat[:t1 - t0] = ((w[:, None] >> pos.to(dev)[(t // N) % C]) & 1).to(torch.bool)
        out.append(flat)
    return Sharded(out, 0)


def _extend(fn, state, cols, base_off: int, row0: int, m: int):
    """``fn`` (a row-sliced extend) over rows [row0, row0 + m) in slices of
    ``otext.EXT_ROWS``, the column words ``cols`` being those rows' ->
    the slices' outputs."""
    outs = []
    for r in range(0, m, otext.EXT_ROWS):
        mc = min(otext.EXT_ROWS, m - r)
        outs.append(fn(*state, cols(r, mc), base_off, row0 + r, mc))
    return outs


def snd_extend(ks: KernelShard, snd: otext.OtExtSender, u_np):
    """Sender half of the row-sharded extension: the peer's u matrix padded
    to the planar word extent, Q rows per shard (rows at or past B·S
    zeroed), the session's cursors advanced as one ``extend`` would.
    Returns (Q rows int32[bloc·S, 4] per shard, idx0 — the pre-batch pad
    index base)."""
    B, S = ks.B, ks.S
    idx0, off = snd.consumed, snd.stream_offset
    u_np = np.asarray(u_np, np.uint32)
    u_pad = np.zeros((otext.KAPPA, ks.bp * S // 32), np.uint32)
    u_pad[:, :u_np.shape[1]] = u_np
    seeds, s_bits = snd.shard_state
    m = ks.bloc * S
    q = []
    for j, dev in enumerate(ks.devices):
        row0 = j * m
        u_j = words_from_numpy(u_pad[:, row0 // 32:(row0 + m) // 32], dev)
        parts = _extend(otext.sender_extend_rows, (seeds.to(dev), s_bits.to(dev)),
                        lambda r, mc: u_j[:, r // 32:r // 32 + -(-mc // 32)], off, row0, m)
        rows = torch.cat(parts)
        live = torch.arange(row0, row0 + m, device=dev) < B * S
        q.append(torch.where(live[:, None], rows, 0))
    snd.advance(B * S)
    return Sharded(q, 0), idx0


def rcv_extend(ks: KernelShard, rcv: otext.OtExtReceiver, flat: Sharded):
    """Receiver half: per shard its choices (the strings' bits) -> (u
    column words int32[128, bloc·S/32] per shard, T rows int32[bloc·S, 4]
    per shard, idx0).  The wire u matrix is :func:`u_wire` of the first."""
    B, S = ks.B, ks.S
    idx0, off = rcv.consumed, rcv.stream_offset
    seeds0, seeds1 = rcv.shard_state
    m = ks.bloc * S
    us, ts = [], []
    for j, dev in enumerate(ks.devices):
        choices = flat[j].reshape(m)
        parts = _extend(otext.receiver_extend_rows, (seeds0.to(dev), seeds1.to(dev)),
                        lambda r, mc: choices[r:r + mc], off, j * m, m)
        us.append(torch.cat([u for u, _ in parts], dim=1))
        ts.append(torch.cat([t for _, t in parts]))
    rcv.advance(B * S)
    return Sharded(us, 1), Sharded(ts, 0), idx0


def _b2a_pair_shard(field, b2a_seed, B: int, bloc: int, t0: int, W: int, garbler: int,
                    device):
    """Tests [t0, t0 + bloc) of ``secure.b2a_payload_pair``'s draw (word
    ``t·W`` on for test t, so block ``t0·W/16`` on; t0 is block-aligned):
    (r1 — the sender's additive shares, w0, w1 payload words), the payload
    words zeroed for tests at or past B."""
    seed = words_from_numpy(b2a_seed, device)
    one = field.from_int(1, device)
    r1 = (torch.empty((bloc, 8), dtype=torch.int32, device=device) if field.limb_shape
          else torch.empty(bloc, dtype=torch.int64, device=device))
    w0 = torch.empty((bloc, W), dtype=torch.int32, device=device)
    w1 = torch.empty_like(w0)
    for b0 in range(0, bloc, secure.B2A_TESTS):
        b1 = min(bloc, b0 + secure.B2A_TESTS)
        words = prg.stream_words(seed, (b1 - b0) * W, offset=(t0 + b0) * W // 16)
        r0 = field.sample(words.reshape(b1 - b0, W))
        r1[b0:b1] = field.sub(r0, one) if garbler else field.add(r0, one)
        w0[b0:b1] = secure.field_to_words(field, r0)
        w1[b0:b1] = secure.field_to_words(field, r1[b0:b1])
    live = (torch.arange(t0, t0 + bloc, device=device) < B)[:, None]
    return r1, torch.where(live, w0, 0), torch.where(live, w1, 0)


def gb_kernel(ks: KernelShard, s_block, q: Sharded, flat: Sharded, gc_seed, b2a_seed, field,
              garbler: int, path: str, idx0: int):
    """Sender whole-level kernel per shard: the 1-of-2^S table (the ot2s
    encrypt kernel) or the garbled batch (the garble kernel, fed the
    shard's carved X0 and mask, R = the OT delta ``s_block`` and Y0 = the
    shard's Q rows).  Returns (planes int32[n_planes, bloc] per shard,
    vals — the sender's additive shares r1 per shard)."""
    B, S, bloc = ks.B, ks.S, ks.bloc
    W = secure.payload_words(field)
    R = np.asarray(s_block, np.uint32).tolist()
    planes, vals = [], []
    for j, dev in enumerate(ks.devices):
        t0 = j * bloc
        r1, w0, w1 = _b2a_pair_shard(field, b2a_seed, B, bloc, t0, W, garbler, dev)
        # result 1 (strings equal) -> the receiver learns r0 (collect.rs:439-456)
        if path == "ot2s":  # the shard's rows past B are zero: its pad tests
            msg = otext_cuda.enc_planar(q[j].reshape(bloc, S, 4), s_block, flat[j], w1, w0,
                                        idx0 + t0).reshape(-1, bloc)
        else:
            X0, mask = gc._carve_label_words_shard(words_from_numpy(gc_seed, dev), B, S, t0,
                                                   bloc)
            msg = torch.cat(gc_cuda.garble_planar(
                R, gc.planarize(X0, bloc), gc.planarize(q[j].reshape(bloc, S, 4), bloc),
                gc.planarize(flat[j], bloc), gc.planarize(mask, bloc),
                gc.planarize(w1, bloc), gc.planarize(w0, bloc), idx0 + t0))
        planes.append(msg)
        vals.append(r1)
    return Sharded(planes, 1), Sharded(vals, 0)


def ev_open(ks: KernelShard, t_rows: Sharded, flat: Sharded, msg_np, field, path: str,
            idx0: int) -> Sharded:
    """Receiver whole-level open per shard: each shard takes its column
    slice of the wire frame and opens it (the ot2s decrypt kernel, or the
    eval kernel) -> field values per shard (r0 where equal, else r1; pad
    slots hold garbage that the share sums never read)."""
    S, bloc = ks.S, ks.bloc
    W = secure.payload_words(field)
    n_planes = n_msg_planes(path, S, W)
    msg = words_from_numpy(msg_np, "cpu").reshape(n_planes, ks.bp)
    vals = []
    for j, dev in enumerate(ks.devices):
        t0 = j * bloc
        m_j = msg[:, t0:t0 + bloc].to(dev)
        if path == "ot2s":  # the shard's planes [2^S * W, bloc], opened test-major
            pay = otext_cuda.dec_planar(t_rows[j].reshape(bloc, S, 4), flat[j], m_j, idx0 + t0)
        else:
            tab, gbl, dec, cts = torch.split(m_j, [(S - 1) * 8, 4 * S, 1, 2 * W])
            _, pay = gc_cuda.eval_planar(gbl, gc.planarize(t_rows[j].reshape(bloc, S, 4), bloc),
                                         tab, dec, cts, idx0 + t0)
            pay = gc.unplanarize(pay, bloc)
        vals.append(secure.words_to_field(field, pay))
    return Sharded(vals, 0)


def share_sums(ks: KernelShard, field, vals: Sharded, weight, F: int, C: int, N: int):
    """Alive-gated per-(node, pattern) share sums [F, C(, limbs)] of the
    test-sharded b2a values, on the first shard's device: each shard sums
    the node rows its tests cover (the rows it shares with a neighbour
    partly), and the partials fold with ``field_psum``.  The exact sum
    mod p."""
    limb = field.limb_shape
    G = F * C
    wflat = weight.reshape(G, N)
    dev0 = ks.devices[0]
    parts = []
    for j, dev in enumerate(ks.devices):
        t0 = j * ks.bloc
        t1 = min(t0 + ks.bloc, ks.B)
        part = field.zeros((G,), dev)
        if t1 > t0:
            g0, g1 = t0 // N, -(-t1 // N)
            frame = field.zeros(((g1 - g0) * N,), dev)
            frame[t0 - g0 * N:t1 - g0 * N] = vals[j][:t1 - t0]
            v = frame.reshape((g1 - g0, 1, N) + limb)
            w = wflat[g0:g1].to(dev).reshape(g1 - g0, 1, N)
            part[g0:g1] = secure.node_share_sums(field, v, w).reshape((g1 - g0,) + limb)
        parts.append(part.to(dev0))
    return field_psum(field, torch.stack(parts), dim=0).reshape((F, C) + limb)


# ---------------------------------------------------------------------------
# Per-shard readback, assembled by position
# ---------------------------------------------------------------------------


def start_host_copies(parts) -> list:
    """Start every shard's device-to-host copy into a pinned buffer of its
    own without waiting (a CPU part is read as it is); -> the copies in
    flight, ``(buffer, event or None)`` per shard."""
    out = []
    for p in parts:
        if p.device.type == "cuda":
            buf = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
            buf.copy_(p, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            out.append((buf, ev))
        else:
            out.append((p.contiguous(), None))
    return out


def assemble(arr) -> np.ndarray:
    """The host array of a :class:`Sharded`: each shard's readback lands at
    its own index span along the split axis of one preallocated array
    (int32 words stay int32).  A plain tensor is read back whole."""
    if not isinstance(arr, Sharded):
        return arr.detach().cpu().numpy()
    copies = start_host_copies(arr)
    dim = arr.dim % arr[0].dim()
    shape = list(arr[0].shape)
    shape[dim] = sum(p.shape[dim] for p in arr)
    out = np.empty(shape, dtype=torch.empty(0, dtype=arr[0].dtype).numpy().dtype)
    lo = 0
    for (buf, ev), p in zip(copies, arr):
        if ev is not None:
            # fhh-lint: disable=host-sync-in-hot-loop (every shard's copy was started before this loop: each wait joins its own copy, one readback of the whole level)
            ev.synchronize()
        idx = [slice(None)] * len(shape)
        idx[dim] = slice(lo, lo + p.shape[dim])
        # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (a view of the pinned host buffer the copy above landed in: no device read)
        out[tuple(idx)] = buf.numpy()
        lo += p.shape[dim]
    return out


def u_wire(ks: KernelShard, u: Sharded) -> np.ndarray:
    """The wire u matrix uint32[128, ceil(B·S/32)]: the shards' columns
    assembled and cut to the real extension's width — a whole-level
    ``extend``'s message byte for byte."""
    wu = -(-ks.B * ks.S // 32)
    return np.ascontiguousarray(assemble(u).view(np.uint32)[:, :wu])


def msg_wire(ks: KernelShard, planes: Sharded) -> np.ndarray:
    """The wire frame uint32[n_planes·bp]: plane-major, each plane the
    shards' slices in order — the whole-level message byte for byte."""
    return assemble(planes).view(np.uint32).reshape(-1)


# ---------------------------------------------------------------------------
# Both roles in one process (the sharded warmup and the tests; on the socket
# path each half runs on its own server)
# ---------------------------------------------------------------------------


def run_level_pair(ks: KernelShard, snd: otext.OtExtSender, rcv: otext.OtExtReceiver,
                   flat_snd: Sharded, flat_rcv: Sharded, gc_seed, b2a_seed, field,
                   garbler: int, path: str):
    """One sharded whole-level 2PC, both roles, the wire arrays through
    host numpy as on the socket path.  Returns (u_np, msg_np, vals_snd,
    vals_rcv), the values still per shard."""
    u, t_rows, idx0_r = rcv_extend(ks, rcv, flat_rcv)
    u_np = u_wire(ks, u)
    q, idx0_s = snd_extend(ks, snd, u_np)
    planes, vals_s = gb_kernel(ks, snd.s_block, q, flat_snd, gc_seed, b2a_seed, field,
                               garbler, path, idx0_s)
    msg_np = msg_wire(ks, planes)
    vals_r = ev_open(ks, t_rows, flat_rcv, msg_np, field, path, idx0_r)
    return u_np, msg_np, vals_s, vals_r
