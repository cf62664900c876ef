"""In-process protocol driver: a leader and two colocated server states.

The port of ``fuzzyheavyhitters_tpu/protocol/driver.py``: both servers'
state machines live in one process on one device.  Two data planes:

- trusted exchange: the per-(node, client) packed share bits are compared
  directly (the counts the leader would reconstruct anyway, ref:
  collect.rs:945-964);
- secure exchange (``Leader.secure`` set): per level the two servers run
  the whole-level 2PC of ``protocol/secure.py`` — the evaluator's Δ-OT
  extension, the garbler's one planar message (1-of-2^S table or packed
  garbled batch), the evaluator's open — and each sums its additive field
  shares per (node, pattern); the leader reconstructs ``sh0 - sh1``.  The
  garbler alternates per level (``g = level % 2``, as the JAX package's
  ``parallel/mesh.py``), each direction on its own OT-extension session
  (:class:`SecureSessions`); inner levels count in FE62, the last in F255
  (ref: rpc.rs:60-62).

Level-loop semantics mirror the reference leader (ref: leader.rs:185-297):

- threshold = ``max(1, threshold · nreqs)`` (leader.rs:193-194);
- each level: expand → count → threshold → prune → advance;
- prune keeps only above-threshold children (leader.rs:229-234), in
  (node, pattern) order, so ``f_max`` truncation and the paths match the
  JAX package exactly;
- paths decode MSB-first per dim; heavy hitters are the surviving leaves.

Radix-2^k level fusion (``Leader.radix``, trusted exchange only): each
round crawls bit levels ``[level, level + r)``, ``r = min(radix, data_len
- level)``, with one fused expansion per server
(``collect.expand_share_bits_radix``), one count over the 2^(r·d) fused
children and one prune, walked in the radix-1 crawl's survivor order
(``collect.radix_pattern_order``), so hitters, ``f_max`` truncation and
paths are those of the radix-1 crawl.  As in the JAX package, the
streamed crawl and the secure exchange run radix 1 only: fused secure
levels run over the socket deployment.

Streaming (servers over ``ibdcf.HostKeys``, trusted exchange only): the
keys stay in host memory; each server's correction words ride
to the card in windows of ``stream_window`` levels (the next window's copy
starts as a window is entered), and the advance re-expands the surviving
parents ``stream_chunk`` node slots at a time (``collect.advance_from_cw``)
instead of keeping a child cache.

Checkpoint/resume (``Leader.run(checkpoint_path, checkpoint_every,
resume)``) writes the JAX package's file, key for key and dtype for dtype,
so a crawl checkpointed by either package resumes under the other.

Per-level host timings go to ``Leader.timings`` (a plain dict of lists).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import secrets as _secrets
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import baseot, otext
from ..ops.fields import F255, FE62
from ..ops.ibdcf import EvalState, HostKeys, IbDcfKeyBatch
from ..utils import resolve_device, tensor_from_numpy, words_from_numpy, words_to_numpy
from . import collect, secure


SECURE_PHASES = ("otext", "b2a", "garble", "eval", "field")
FP_CHUNK = 4096  # clients per step of the key fingerprint's checksum


def slim_root_batch(keys: HostKeys, device) -> IbDcfKeyBatch:
    """The root-only key batch ``collect.tree_init`` needs in streaming
    mode: the real root seeds and ``key_idx`` on ``device``, zero-length
    correction-word axes (uploading those is what streaming avoids)."""
    batch = tuple(keys.key_idx.shape)
    dev = torch.device(device)
    return IbDcfKeyBatch(
        key_idx=keys.key_idx.to(dev), root_seed=keys.root_seed.to(dev),
        cw_seed=torch.zeros(batch + (0, 4), dtype=torch.int32, device=dev),
        cw_bits=torch.zeros(batch + (0, 2), dtype=torch.bool, device=dev),
        cw_y_bits=torch.zeros(batch + (0, 2), dtype=torch.bool, device=dev))


class CwWindows:
    """One server's correction words, streamed from :class:`HostKeys` to
    ``device`` in windows of ``window`` levels: levels ``[lo, hi)`` are
    one contiguous slice of the host keys.  :meth:`at` hands out one
    level's cw from the current window; entering a window starts the next
    one's upload.  On a card each window is copied into one of two pinned
    staging buffers (never one whose last copy is still in flight) and
    from there to the card with ``non_blocking`` copies on a side stream;
    the compute stream waits on the copy's event when it enters the
    window, and the window's tensors are recorded on it.  Elsewhere a
    window is a plain copy."""

    def __init__(self, keys: HostKeys, window: int, device):
        self.keys, self.window, self.device = keys, window, torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._staging = [None, None]  # pinned (cws, cwf) pairs, allocated on first use
        self._done = [None, None]  # event of each staging buffer's last copy
        self._slot = 0
        self._stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._cur = None  # (lo, (cws, cwf)) of the window in use
        self._next = None  # (lo, upload handle) of the window after it

    def at(self, level: int):
        """Level ``level``'s ``(cws int32[4, d2, N], cwf uint8[d2, N])``
        on the device (views into the window, contiguous)."""
        W, L = self.window, self.keys.data_len
        lo = (level // W) * W
        if self._cur is None or self._cur[0] != lo:
            nxt, self._next = self._next, None
            handle = nxt[1] if nxt is not None and nxt[0] == lo else self._start(lo)
            self._cur = (lo, self._ready(handle))
            if lo + W < L:
                self._next = (lo + W, self._start(lo + W))
        cws, cwf = self._cur[1]
        return cws[level - lo], cwf[level - lo]

    def _start(self, lo: int):
        """Begin the upload of the window at ``lo``; returns a handle for
        :meth:`_ready`."""
        hi = min(lo + self.window, self.keys.data_len)
        host = (self.keys.cws[lo:hi], self.keys.cwf[lo:hi])
        if not self.cuda:
            return tuple(a.to(self.device) for a in host), None
        k, self._slot = self._slot, self._slot ^ 1
        if self._staging[k] is None:
            self._staging[k] = tuple(
                torch.empty((self.window,) + tuple(a.shape[1:]), dtype=a.dtype,
                            pin_memory=True) for a in host)
        if self._done[k] is not None:
            self._done[k].synchronize()  # the buffer's last copy has left it
        stage = tuple(buf[:hi - lo] for buf in self._staging[k])
        for buf, a in zip(stage, host):
            buf.copy_(a)
        with torch.cuda.stream(self._stream):
            dev = tuple(torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
                        for buf in stage)
            for d, buf in zip(dev, stage):
                d.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._done[k] = ev
        return dev, ev

    def _ready(self, handle):
        """The window's device tensors, ordered after their copy on the
        current stream."""
        dev, ev = handle
        if ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in dev:
                t.record_stream(cur)
        return dev


def _device_checksum(a: torch.Tensor) -> torch.Tensor:
    """Position-weighted mod-2^32 checksum of ``a`` (client axis first)
    over its clients: the sum of ``a[i] * (2 i + 1)``, in int64 masked to
    32 bits, FP_CHUNK clients at a time."""
    mask = 0xFFFFFFFF
    red = None
    for i in range(0, a.shape[0], FP_CHUNK):
        p = a[i:i + FP_CHUNK].to(torch.int64) & mask
        w = (torch.arange(i, i + p.shape[0], dtype=torch.int64, device=a.device) * 2 + 1)
        part = ((p * w.reshape((-1,) + (1,) * (p.ndim - 1))) & mask).sum(0) & mask
        red = part if red is None else (red + part) & mask
    return red


def _host_checksum(a: np.ndarray, bit: int | None = None) -> np.ndarray:
    """The same checksum on the host with the client axis LAST, in numpy
    uint32 arithmetic (which wraps mod 2^32); ``bit`` takes that bit of
    each uint8 flag instead of the value."""
    red = np.zeros(a.shape[:-1], np.uint32)
    for i in range(0, a.shape[-1], FP_CHUNK):
        p = a[..., i:i + FP_CHUNK]
        if bit is not None:
            p = (p >> bit) & 1
        w = np.arange(i, i + p.shape[-1], dtype=np.uint32) * np.uint32(2) + np.uint32(1)
        red += (p * w).sum(axis=-1, dtype=np.uint32)
    return red


def _key_planes(keys, device):
    """The three reduced cw planes of one party, in the JAX package's hash
    order and layout: seeds [d, 2, L, 4], t bits [d, 2, L, 2], y bits
    [d, 2, L, 2], each uint32 — reduced on the device for device keys,
    on the host for :class:`HostKeys`."""
    if isinstance(keys, HostKeys):
        L, _, d2, _ = keys.cws.shape
        d = d2 // 2
        seeds = _host_checksum(keys.cws.numpy().view(np.uint32))  # [L, 4, d2]
        flags = [_host_checksum(keys.cwf.numpy(), k) for k in range(4)]  # [L, d2] each
        return [seeds.transpose(2, 0, 1).reshape(d, 2, L, 4),
                np.stack(flags[:2], -1).transpose(1, 0, 2).reshape(d, 2, L, 2),
                np.stack(flags[2:], -1).transpose(1, 0, 2).reshape(d, 2, L, 2)]
    return [_device_checksum(a).cpu().numpy().astype(np.uint32)
            for a in (keys.cw_seed, keys.cw_bits, keys.cw_y_bits)]


class PhaseClock:
    """Seconds per named phase, as ``with clock(name): ...`` around the
    work (the ``phase`` argument of ``protocol/secure.py``).  On the card a
    phase is the span of the device stream between CUDA events recorded
    around it — no sync of its own — read by :meth:`settle` once a readback
    has waited for the work; on the CPU it is host time."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spent: dict = {}
        self._marks: list = []  # (phase, start event, end event)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            yield
            ev[1].record()
            self._marks.append((name, *ev))
            return
        t = time.perf_counter()
        yield
        self.spent[name] = self.spent.get(name, 0.0) + time.perf_counter() - t

    def settle(self) -> dict:
        """Seconds per phase since the last settle (waits for the events)."""
        for name, start, end in self._marks:
            end.synchronize()
            self.spent[name] = self.spent.get(name, 0.0) + start.elapsed_time(end) / 1e3
        out, self.spent, self._marks = self.spent, {}, []
        return out


@dataclass
class ServerState:
    """One collector server's state (ref: server.rs:44-52)."""

    keys: IbDcfKeyBatch | HostKeys  # [N, d, 2]; HostKeys when streaming
    alive_keys: torch.Tensor  # bool[N] liveness flags on the crawl's device (ref: collect.rs:32)
    frontier: collect.Frontier | None = None
    children: collect.PlanarChildren | None = None


@dataclass
class SecureSessions:
    """The secure crawl's OT state: one extension session per garbling
    direction.  In session g server g is the extension sender (garbler),
    holding ``snd[g]``, and server 1 - g the receiver, holding ``rcv[g]``.
    ``sec_seed`` derives the per-level GC and b2a seeds."""

    snd: tuple
    rcv: tuple
    sec_seed: np.ndarray
    crawl_ctr: int = 0


def session_material(rng=None) -> dict:
    """Base-OT material of both sessions and the session seed, from ``rng``
    (``secrets.SystemRandom`` by default; a seeded ``random.Random`` gives
    reproducible sessions): ``{"sessions": [(s_bits, seeds0, seeds1,
    chosen)] * 2, "sec_seed": uint32[4]}``."""
    mats = []
    for _ in range(2):
        s_bits = otext.fresh_s_bits(rng)
        seeds0, seeds1, chosen = baseot.exchange(s_bits, rng)
        mats.append((s_bits, seeds0, seeds1, chosen))
    if rng is None:
        sec_seed = np.frombuffer(_secrets.token_bytes(16), "<u4").copy()
    else:
        sec_seed = np.array([rng.getrandbits(32) for _ in range(4)], np.uint32)
    return {"sessions": mats, "sec_seed": sec_seed}


def make_sessions(material: dict, device) -> SecureSessions:
    snd, rcv = [], []
    for s_bits, seeds0, seeds1, chosen in material["sessions"]:
        snd.append(otext.OtExtSender(s_bits, chosen, device))
        rcv.append(otext.OtExtReceiver(seeds0, seeds1, device))
    return SecureSessions(snd=tuple(snd), rcv=tuple(rcv),
                          sec_seed=np.asarray(material["sec_seed"], np.uint32))


@dataclass
class CrawlResult:
    paths: np.ndarray  # bool[H, d, L] per-dim MSB-first paths
    counts: np.ndarray  # int64[H]

    def decode_ints(self) -> np.ndarray:
        """paths -> int[H, d] leaf values (MSB-first per dim); domains of
        63+ bits decode through Python ints (object dtype)."""
        L = self.paths.shape[-1]
        if L < 63:
            weights = 1 << np.arange(L - 1, -1, -1)
            return (self.paths.astype(np.int64) * weights).sum(-1)
        vals = np.zeros(self.paths.shape[:-1], dtype=object)
        for i in range(L):
            vals = (vals << 1) | self.paths[..., i].astype(object)
        return vals


@dataclass
class Leader:
    """Drives two ServerStates level by level (ref: leader.rs:185-297)."""

    server0: ServerState
    server1: ServerState
    n_dims: int
    data_len: int
    f_max: int = 256
    secure: SecureSessions | None = None  # None: trusted exchange
    ot_path: str = "auto"  # secure equality engine (secure.ot_path)
    min_bucket: int = 1  # the least frontier bucket; shapes only, never hitters
    # streaming (the servers' keys are HostKeys): cw uploaded in windows of
    # stream_window levels, no child cache; the advance re-expands
    # stream_chunk parent slots at a time (None: the whole bucket)
    stream_chunk: int | None = None
    stream_window: int = 64
    radix: int = 1  # bit levels per crawl round (Config.crawl_radix_bits)
    paths: np.ndarray = field(default=None)  # bool[F, d, level]
    n_nodes: int = 0
    buckets: list = field(default_factory=list)  # frontier bucket per round
    # seconds per round, host clock: "expand" (enqueue of both servers'
    # expansions, and the strings in a secure crawl), "count" (counts, or
    # the leader's reconstruction, and the readback that waits for the
    # device), "advance" (prune bookkeeping + enqueue of both gathers, or
    # when streaming both re-expanding advances); a
    # secure crawl adds the socket server's phases "otext", "b2a",
    # "garble", "eval" and "field" (the share sums): on the card each is
    # the span on the device stream between CUDA events recorded around
    # it (no sync of its own), on the CPU its host time
    timings: dict = field(default_factory=dict)

    def __post_init__(self):
        if not 1 <= self.n_dims <= collect.MAX_DIMS:
            raise ValueError(f"n_dims={self.n_dims}: supported 1..{collect.MAX_DIMS}")
        collect.check_radix(self.n_dims, self.radix)
        if self.radix > 1 and self.stream:
            raise ValueError("streaming crawl mode pins crawl_radix_bits=1 "
                             "(advance_from_cw re-expands one bit per level)")
        if self.radix > 1 and self.secure is not None:
            raise ValueError("the in-process secure crawl pins crawl_radix_bits=1 (as the JAX "
                             "package's): fused secure levels run over the socket deployment "
                             "(bin.server and bin.leader)")
        if isinstance(self.server1.keys, HostKeys) != self.stream:
            raise TypeError("both servers' keys are ibdcf.HostKeys (a streamed crawl) "
                            "or neither is")
        self._cw = None  # per server a CwWindows when streaming
        if self.stream:
            if self.secure is not None:
                raise ValueError("streaming crawl mode runs the trusted exchange only "
                                 "(the JAX package has no secure streaming crawl)")
            self._cw = [CwWindows(s.keys, self.stream_window, self.device)
                        for s in (self.server0, self.server1)]
        self._key_fp = None

    @property
    def device(self) -> torch.device:
        return self.server0.alive_keys.device

    @property
    def stream(self) -> bool:
        """Whether the crawl streams: the servers' keys are HostKeys."""
        return isinstance(self.server0.keys, HostKeys)

    def _reset(self):
        """Per-crawl bookkeeping: timings, buckets."""
        self.buckets = []
        names = ["expand", "count", "advance"]
        if self.secure is not None:
            names += list(SECURE_PHASES)
        self.timings = {k: [] for k in names}

    def tree_init(self):
        for s in (self.server0, self.server1):
            keys = slim_root_batch(s.keys, self.device) if self.stream else s.keys
            s.frontier = collect.tree_init(keys, self.min_bucket)
            s.children = None
        self.paths = np.zeros((1, self.n_dims, 0), bool)
        self.n_nodes = 1
        self._reset()

    def run_level(self, level: int, nreqs: int, threshold: float) -> int:
        """One expand -> count -> threshold -> prune -> advance round over
        bit levels ``[level, level + r)``, ``r = min(radix, data_len -
        level)``; returns the surviving node count.  The last round builds
        no child cache and leaves no frontier: nothing advances past it.
        When streaming, the level expands without a child cache and the
        advance re-expands the survivors' parents."""
        d = self.n_dims
        r = min(self.radix, self.data_len - level)
        last = level + r == self.data_len
        servers = (self.server0, self.server1)
        alive_nodes = self.server0.frontier.alive
        t0 = time.perf_counter()
        packed, cws = [], []
        for i, s in enumerate(servers):
            if self.stream:
                cws.append(self._cw[i].at(level))
                p, _ = collect.expand_share_bits_from_cw(cws[i], s.frontier, want_children=False)
            else:
                p, s.children = collect.expand_share_bits_radix(
                    s.keys, s.frontier, level, r, want_children=not last)
                s.frontier = None  # the child cache is all the advance needs
            packed.append(p)
        self.buckets.append(int(alive_nodes.shape[0]))
        if self.secure is not None:
            counts, t1, tc = self._secure_counts(level, packed, alive_nodes, last)
        else:
            t1 = tc = time.perf_counter()
            counts = collect.counts_by_pattern(
                packed[0], packed[1], collect.pattern_masks_radix(d, r),
                self.server0.alive_keys, alive_nodes,
            )
            # the one per-level readback: thresholding is leader logic
            counts = counts.cpu().numpy()  # [F, 2^(r·d)]
        del packed
        t2 = time.perf_counter()
        thresh = max(1, int(threshold * nreqs))  # ref: leader.rs:193-194
        # fused children in the radix-1 crawl's visit order (the identity
        # at r = 1), so survivors and f_max truncation are the same
        order = collect.radix_pattern_order(d, r)
        keep = counts[:, order] >= thresh
        keep[self.n_nodes:, :] = False
        parent, rank, n_alive = collect.compact_survivors(keep, self.f_max, self.min_bucket)
        pattern = order[rank]
        pat_bits = collect.pattern_to_bits_radix(pattern, d, r)  # [F', r, d]
        if not last and (n_alive or not self.stream):
            parent_t = torch.from_numpy(parent.astype(np.int64)).to(self.device)
            pat_t = torch.from_numpy(pat_bits).to(self.device)
            for i, s in enumerate(servers):
                if self.stream:
                    # drop every reference to the old frontier before the
                    # next server advances: two old and two new frontiers
                    # at once are what overflows the card at wide levels
                    old, s.frontier = s.frontier, None
                    s.frontier = collect.advance_from_cw(cws[i], old, parent_t, pat_t[:, 0],
                                                         n_alive, self.stream_chunk)
                    del old
                else:
                    s.frontier = collect.advance_from_children_radix(
                        s.children, parent_t, pat_t, n_alive, r)
                    s.children = None
        else:
            for s in servers:
                s.frontier = s.children = None
        self.paths = np.concatenate(
            [self.paths[parent[:n_alive]], pat_bits[:n_alive].transpose(0, 2, 1)], axis=-1)
        self.n_nodes = n_alive
        self._last_counts = counts[parent[:n_alive], pattern[:n_alive]]
        t3 = time.perf_counter()
        self.timings["expand"].append(t1 - t0)
        self.timings["count"].append(t2 - tc)
        self.timings["advance"].append(t3 - t2)
        return n_alive

    def _secure_counts(self, level: int, packed: list, alive_nodes, last: bool):
        """One secure level after both expansions: strings, the whole-level
        2PC with garbler ``level % 2``, share sums, reconstruction.
        Returns (counts int64[F, 2^d], the host times at which the strings
        were ready and the reconstruction began)."""
        sec, d = self.secure, self.n_dims
        phase = PhaseClock(packed[0].device)
        field_ = F255 if last else FE62
        g = level % 2
        ev = 1 - g
        strs = [secure.child_strings(p, d) for p in packed]
        F, C, N, S = strs[0].shape
        B = F * C * N
        flat = [s.reshape(B, S) for s in strs]
        del strs
        t1 = time.perf_counter()
        sec.crawl_ctr += 1
        gseed = secure.derive_seed(sec.sec_seed, 1, level, sec.crawl_ctr)
        bseed = secure.derive_seed(sec.sec_seed, 2, level, sec.crawl_ctr)
        u, t_rows, idx0 = secure.ev_step1_fused(sec.rcv[g], flat[ev], phase=phase)
        msg, vals_g = secure.gb_step_level(sec.snd[g], u, flat[g], gseed, bseed, field_,
                                           g, self.ot_path, phase=phase)
        del u
        vals_ev = secure.ev_open_level(t_rows, flat[ev], msg, B, S, field_, idx0,
                                       self.ot_path, phase=phase)
        del msg, t_rows, flat
        vals = {g: vals_g, ev: vals_ev}
        with phase("field"):
            w = secure.alive_weight(alive_nodes, self.server0.alive_keys, C)
            shape = (F, C, N) + field_.limb_shape
            sh = [secure.node_share_sums(field_, vals[s].reshape(shape), w) for s in (0, 1)]
        del vals, vals_g, vals_ev
        tc = time.perf_counter()
        # leader reconstruction: v0 - v1 per (node, pattern); the readback
        # waits for the level's device work, so every phase event is done
        if last:
            limbs = words_to_numpy(F255.sub(sh[0], sh[1]))  # [F, C, 8]
            if limbs[..., 1:].any():
                raise RuntimeError("non-count residue in F255 shares")
            v = limbs[..., 0].astype(np.int64)
        else:
            v = FE62.canon(FE62.sub(sh[0], sh[1])).cpu().numpy()
            if (v > N).any():  # e.g. a share-sign or role mismatch
                raise RuntimeError("count reconstruction out of range")
        spent = phase.settle()
        for k in SECURE_PHASES:
            self.timings[k].append(spent.get(k, 0.0))
        return v, t1, tc

    def run(self, nreqs: int, threshold: float, checkpoint_path: str | None = None,
            checkpoint_every: int = 64, resume: bool = False) -> CrawlResult:
        """Full crawl: init + data_len levels in rounds of ``radix`` + final
        reconstruction (ref: leader.rs:417-438 then final_shares at
        :282-297).

        ``checkpoint_path`` persists the crawl state after each round that
        completes a multiple of ``min(checkpoint_every, max(1, data_len //
        2))`` levels (so a short crawl still checkpoints mid-crawl), never
        after the last round; ``resume=True`` restores from that file when
        it exists and continues from the next round.  Keys are not in the file: build
        the Leader over the same keys to resume.  A crawl that completes
        removes the file."""
        if checkpoint_path is not None and self.secure is not None:
            raise ValueError("checkpoint/resume covers the trusted crawl: the secure "
                             "crawl's OT-session state is not in the checkpoint")
        if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
            start = self.restore(checkpoint_path, nreqs, threshold)
        else:
            start = 0
            self.tree_init()

        def done(result):
            if checkpoint_path is not None and os.path.exists(checkpoint_path):
                os.remove(checkpoint_path)
            return result

        every = min(checkpoint_every, max(1, self.data_len // 2))
        for level in range(start, self.data_len, self.radix):
            r = min(self.radix, self.data_len - level)
            n = self.run_level(level, nreqs, threshold)
            if n == 0:
                return done(CrawlResult(
                    paths=np.zeros((0, self.n_dims, level + r), bool),
                    counts=np.zeros(0, np.int64),
                ))
            # checkpoints fall on the fused grid: after the round that
            # ends on a multiple of ``every``
            if checkpoint_path is not None and level + r < self.data_len \
                    and (level + r) % every == 0:
                self.checkpoint(checkpoint_path, level, nreqs, threshold)
        return done(CrawlResult(paths=self.paths, counts=self._last_counts))

    # -- checkpoint / resume --------------------------------------------------

    def _key_fingerprint(self) -> np.ndarray:
        """uint8[32]: SHA-256 over both servers' key identities, byte for
        byte the JAX package's — per server ``key_idx`` and ``root_seed``
        raw, then each cw plane (seeds [N, d, 2, L, 4], t and y bits [N, d,
        2, L, 2]) reduced over the client axis by the position-weighted
        checksum ``sum plane[i] * (2 i + 1) mod 2^32`` (an odd weight is
        invertible mod 2^32, so any single client's change moves it), as
        uint32 [d, 2, L, 4] / [d, 2, L, 2].  Reduced on the card for device
        keys, on the host for HostKeys.  Cached: keys do not change."""
        if self._key_fp is None:
            h = hashlib.sha256()
            reduced = {}  # the parties of one keygen share their cw tensors
            for s in (self.server0, self.server1):
                h.update(np.ascontiguousarray(s.keys.key_idx.cpu().numpy()))
                h.update(np.ascontiguousarray(words_to_numpy(s.keys.root_seed)))
                cw = s.keys[2:]
                key = tuple((t.data_ptr(), t.shape, t.stride()) for t in cw)
                if key not in reduced:
                    reduced[key] = _key_planes(s.keys, self.device)
                for red in reduced[key]:
                    h.update(np.ascontiguousarray(red))
            self._key_fp = np.frombuffer(h.digest(), np.uint8)
        return self._key_fp

    def checkpoint(self, path: str, level: int, nreqs: int | None = None,
                   threshold: float | None = None) -> None:
        """Persist the crawl state after the round based at ``level``
        completed, in the JAX package's npz format (``radix`` stamped): both
        servers' frontiers (plane-major, seeds
        as uint32: ``planar`` True) and liveness flags, the leader's
        paths, ``meta`` = [n_dims, data_len, f_max, min_bucket], the key
        fingerprint and, from :meth:`run`, ``params`` = (nreqs,
        threshold).  Written to ``path.tmp`` and renamed over ``path``."""
        blob = {
            "level": np.int64(level),
            "radix": np.int64(self.radix),
            "planar": np.bool_(True),
            "paths": self.paths,
            "n_nodes": np.int64(self.n_nodes),
            "last_counts": np.asarray(self._last_counts).astype(np.uint32),
            "meta": np.array([self.n_dims, self.data_len, self.f_max, self.min_bucket],
                             np.int64),
            "key_fp": self._key_fingerprint(),
        }
        if nreqs is not None and threshold is not None:
            blob["params"] = np.array([float(nreqs), float(threshold)])
        as_np = lambda t: t.cpu().numpy()
        for i, s in enumerate((self.server0, self.server1)):
            st = s.frontier.states
            blob[f"s{i}_seed"] = words_to_numpy(st.seed)
            blob[f"s{i}_bit"] = as_np(st.bit)
            blob[f"s{i}_y_bit"] = as_np(st.y_bit)
            blob[f"s{i}_alive"] = as_np(s.frontier.alive)
            blob[f"s{i}_alive_keys"] = as_np(s.alive_keys)
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **blob)
        os.replace(tmp, path)

    def restore(self, path: str, nreqs: int | None = None,
                threshold: float | None = None) -> int:
        """Load a checkpoint (this package's or the JAX package's) and
        return the next round's base level.  Refuses, with the live state
        untouched, a file of another shape, radix or key batch, one with
        no key fingerprint, and one written for other (nreqs, threshold).
        A file of the JAX package's interleaved engine (``planar`` False)
        is carried to the plane-major layout."""
        with np.load(path) as npz:  # materialised here: run() removes the file later
            z = {k: npz[k] for k in npz.files}
        want = [self.n_dims, self.data_len, self.f_max, self.min_bucket]
        if z["meta"].tolist() != want:
            raise ValueError(f"checkpoint shape {z['meta'].tolist()} != leader shape {want}")
        # a file of another radix holds a frontier at a depth this leader's
        # round grid never visits (files without the stamp are radix 1)
        saved_radix = int(z["radix"]) if "radix" in z else 1
        if saved_radix != self.radix:
            raise ValueError(f"checkpoint crawl radix {saved_radix} != leader "
                             f"crawl_radix_bits {self.radix}")
        if "key_fp" not in z:
            raise ValueError("checkpoint predates the key-fingerprint format — "
                             "re-run the crawl from the start")
        if not np.array_equal(z["key_fp"], self._key_fingerprint()):
            raise ValueError("checkpoint was written under different key batches")
        if "params" in z and nreqs is not None and threshold is not None:
            saved = z["params"]
            if saved[0] != float(nreqs) or saved[1] != float(threshold):
                raise ValueError(
                    f"checkpoint crawl params (nreqs, threshold) = "
                    f"({saved[0]:g}, {saved[1]:g}) != ({nreqs}, {threshold})")
        dev = self.device
        as_bool = lambda a: tensor_from_numpy(a, dev, bool)
        for i, s in enumerate((self.server0, self.server1)):
            raw = EvalState(seed=z[f"s{i}_seed"], bit=z[f"s{i}_bit"], y_bit=z[f"s{i}_y_bit"])
            if bool(z["planar"]):
                states = EvalState(seed=words_from_numpy(raw.seed, dev), bit=as_bool(raw.bit),
                                   y_bit=as_bool(raw.y_bit))
            else:
                states = collect.states_from_numpy(raw, dev)
            s.frontier = collect.Frontier(states=states, alive=as_bool(z[f"s{i}_alive"]))
            s.children = None
            s.alive_keys = as_bool(z[f"s{i}_alive_keys"])
        self.paths = z["paths"]
        self.n_nodes = int(z["n_nodes"])
        self._last_counts = z["last_counts"].astype(np.int64)
        self._reset()
        lvl = int(z["level"])  # base level of the last completed round
        return lvl + min(self.radix, self.data_len - lvl)


def make_servers(keys0, keys1, device=None):
    """Both servers over their keys: ``IbDcfKeyBatch`` crawl on their own
    device unless ``device`` names one; ``HostKeys`` (a streamed crawl)
    live in host memory, so their crawl runs on ``device``, which is
    ``cuda`` unless the caller names another (``utils.resolve_device``)."""
    n = keys0.key_idx.shape[0]
    if isinstance(keys0, HostKeys):
        dev = resolve_device(device)
    else:
        dev = keys0.key_idx.device if device is None else torch.device(device)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    return ServerState(keys0, alive.clone()), ServerState(keys1, alive.clone())
