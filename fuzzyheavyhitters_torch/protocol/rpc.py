"""The socket deployment: leader↔server control plane and the server↔server
data plane (the port of ``fuzzyheavyhitters_tpu/protocol/rpc.py``).

Process topology of the reference (server.rs, leader.rs): two collector
servers and a leader, each its own process.

- **Control plane.**  The leader connects to both servers and drives the
  eight verbs of the reference's ``Collector`` service (rpc.rs:56-66):
  ``reset, add_keys, tree_init, tree_crawl, tree_crawl_last, tree_prune,
  tree_prune_last, final_shares``, and the JAX server's ``warmup``.
  Frames are length-prefixed pickles (``<Q`` length, protocol 5):
  ``(req_id, verb, payload)`` to a server, ``(req_id, response)`` back; a
  failed verb answers ``{"__error__": "Type: message"}``.
- **Data plane.**  One server↔server TCP connection (server 1 listens on
  its control port + 1, server 0 dials, server.rs:344-354) carrying
  ``(channel, payload)`` frames on channel ``"default"``; a third element,
  the trace header a traced JAX peer adds, is accepted and ignored.

The wire is the JAX package's, frame for frame: every payload is numpy
arrays of its dtypes (uint32 words, uint64 FE62 shares, uint32[..., 8] F255
shares, bool bits, int32 indices), Python scalars, dicts, tuples and bytes —
never a ``torch.Tensor`` (:func:`_send` refuses one) — so a JAX server can
pair with a port server, and either package's leader can drive either pair.

Per plane, once: a 16-byte coin flip (sent in trusted mode too, because a
JAX peer sends it), then in secure mode the two base-OT sessions, one per
garbling direction.  Per level, trusted: the packed share bits are swapped
in role order and both servers count; counts go to the leader masked by
the shared stream of ``protocol/sessions.py``.  Per level, secure: the
whole-level 2PC of ``protocol/secure.py`` with the garbler and ``ot_path``
named by the request; each server returns its additive share sums.

Node spans: a crawl verb may carry ``shard: [lo, hi)``, a span of the
frontier's node axis (``collect.shard_spans``), trusted or secure.  The
server crawls that view of the frontier, swaps that span's frames, answers
that span's counts or shares — the trusted mask rows are sliced from the
whole level's stream, so a node's mask does not depend on the split — and
banks the span's child cache (or, at the last level, its shares) for the
prune, which refuses a torn level.  A span verb that arrives while an
earlier one holds the verb lock runs its expansion at once (the
frame-arrival pre-expand, at most 32 stashed): device work only, it never
touches the data plane, so the frame order stays the JAX package's.

Radix-2^k level fusion (``Config.crawl_radix_bits`` = k, the server's
own, checked at ``tree_init``): the crawl verb based at ``level`` covers
bit levels ``[level, level + r)``, ``r = min(k, data_len - level)``
(``collect.expand_share_bits_radix``; secure strings of S' = 2·d·r bits),
answers 2^(d·r) count columns, and the prune takes fused patterns
``[F', r, d]`` (``[F', d]`` when r = 1, so k = 1 is byte-identical).

``warmup`` runs, for each requested frontier bucket and each span size it
implies, the expansions a crawl at that bucket runs (and the count, or the
whole secure chain on a throwaway in-process OT pair), touching no live
state: the port compiles no XLA, so this is what the JAX verb's compile
pass becomes.

Recovery (the supervised crawl's server half): ``status`` (boot id,
dedup hits, plane resets, checkpoint levels on disk), ``tree_checkpoint``
/ ``tree_restore`` (the frontier as one npz blob a level, in the JAX
package's format, either layout restoring into the other) under the
server's ``ckpt_dir``, and ``plane_reset`` / ``plane_break`` (server 0
redials the data plane, server 1 re-accepts it; every new transport is
re-keyed by the next data-plane verb: the coin flip and, secure, fresh
base-OT sessions).  Every verb runs at most once per (leader session,
request id): ``__hello__`` binds the connection to its leader's session,
a replay of a finished request is answered from the session's bounded
cache (errors too), a replay of one still running awaits that execution.
:class:`CollectorClient` redials after a lost transport and resends under
the same request id.

Not ported (they answer ``NotImplementedError`` naming the missing path,
never "unknown verb"): the other verbs of the JAX server and multi-tenant
collections.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import logging
import os
import pickle
import secrets
import socket
import struct
import time

import numpy as np
import torch

from ..ops import baseot, ibdcf, otext
from ..ops.fields import F255, FE62
from ..resilience import policy as respolicy
from ..ops.ibdcf import EvalState
from ..utils import resolve_device, tensor_from_numpy, words_from_numpy, words_to_numpy
from ..utils.config import Config
from . import collect, secure, sessions
from .driver import PhaseClock
from .sessions import DEFAULT_COLLECTION

_log = logging.getLogger(__name__)
_HDR = struct.Struct("<Q")


def _check_wire(obj) -> None:
    """Raise if a frame holds a ``torch.Tensor``: a JAX peer unpickles
    frames without torch."""
    if isinstance(obj, torch.Tensor):
        raise TypeError("a wire frame holds a torch.Tensor; frames carry numpy arrays")
    if isinstance(obj, dict):
        for v in obj.values():
            _check_wire(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _check_wire(v)


async def _send(writer: asyncio.StreamWriter, obj, count=None) -> None:
    """One frame.  ``count`` is called with the framed byte size."""
    _check_wire(obj)
    data = pickle.dumps(obj, protocol=5)
    if count is not None:
        count(len(data) + _HDR.size)
    writer.write(_HDR.pack(len(data)) + data)
    await writer.drain()


async def _recv(reader: asyncio.StreamReader, count=None):
    """One frame.  Waits indefinitely by design: response waits are bounded
    by the caller's verb budget, the data plane by TCP keepalive."""
    (n,) = _HDR.unpack(await reader.readexactly(_HDR.size))
    if count is not None:
        count(n + _HDR.size)
    return pickle.loads(await reader.readexactly(n))


async def _fetch_words(t: torch.Tensor) -> np.ndarray:
    """int32 device words -> uint32 host array, off the event loop (two
    servers in one loop must not serialize on a device->host copy)."""
    return await asyncio.to_thread(words_to_numpy, t)


def _share_wire(field, sh: torch.Tensor) -> np.ndarray:
    """Share sums in the JAX package's wire dtype: FE62 uint64 bit
    patterns, F255 uint32[..., 8] limbs."""
    if field is F255:
        return words_to_numpy(sh)
    return sh.detach().cpu().numpy().view(np.uint64)


def _keepalive(writer: asyncio.StreamWriter) -> None:
    """TCP keepalive on the data plane, so a silently dead peer surfaces
    as a connection error within about two minutes."""
    sock = writer.get_extra_info("socket")
    if sock is None:
        return
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 20), ("TCP_KEEPCNT", 3)):
        if hasattr(socket, opt):
            sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)


def not_ported(what: str, path: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: {path} is not ported to PyTorch yet")


# the JAX server's other verbs, each with the path it belongs to
UNPORTED_VERBS = {
    "sketch_verify": "the malicious sketch verification",
    "submit_keys": "streaming ingestion",
    "window_seal": "streaming ingestion",
    "window_load": "streaming ingestion",
    "session_export": "collection-session migration",
    "session_import": "collection-session migration",
}

# replay-dedup bounds (the JAX package's): the cache must cover every request
# a client could still replay — its in-flight window (the key upload's 256)
# and slack — and is bounded by bytes too, since crawl answers are share
# arrays; sessions are bounded so that reconnecting leaders cannot grow it
_SESSION_CACHE_CAP = 1024
_SESSION_CACHE_BYTES = 128 << 20
_SESSION_CAP = 8


def _resp_nbytes(resp) -> int:
    """Approximate retained size of a cached response."""
    if isinstance(resp, np.ndarray):
        return resp.nbytes + 64
    if isinstance(resp, dict):
        return 64 + sum(_resp_nbytes(v) for v in resp.values())
    if isinstance(resp, (list, tuple)):
        return 64 + sum(_resp_nbytes(v) for v in resp)
    return 64


class _Session:
    """One leader session's replay state: responses already sent
    (``cache``) and verbs still running (``inflight``)."""

    __slots__ = ("cache", "sizes", "bytes_total", "inflight", "last_seen")

    def __init__(self):
        self.cache: collections.OrderedDict = collections.OrderedDict()
        self.sizes: dict = {}
        self.bytes_total = 0
        self.inflight: dict = {}
        self.last_seen = time.monotonic()

    def put(self, req_id, resp) -> None:
        """Cache a response under the count and byte bounds; the newest
        entry survives even alone over the byte bound (its own replay needs
        it)."""
        nb = _resp_nbytes(resp)
        self.cache[req_id] = resp
        self.sizes[req_id] = nb
        self.bytes_total += nb
        while len(self.cache) > 1 and (len(self.cache) > _SESSION_CACHE_CAP
                                       or self.bytes_total > _SESSION_CACHE_BYTES):
            old, _ = self.cache.popitem(last=False)
            self.bytes_total -= self.sizes.pop(old, 0)


def _load_npz(path: str) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


# the run report's phases: host-clock spans of every level (the JAX server's
# fss, gc_ot, field), then the secure exchange's steps, spans of the device
# stream on the card (driver.PhaseClock)
PHASES = ("fss", "gc_ot", "field", "otext", "b2a", "garble", "eval")


class CollectorServer:
    """One collector server (ref: server.rs:44-172) holding one party's key
    share, its own OT secrets and its own crawl state on ``device``; only
    wire frames cross to the peer.  ``server_id`` 0 dials the peer, 1
    listens.  ``ckpt_dir`` (the binary's ``FHH_CKPT_DIR``) holds the
    checkpoint blobs; without it ``tree_checkpoint`` and ``tree_restore``
    refuse.  ``emit(event, **fields)`` receives the recovery events
    (``resilience.server_checkpoint``, ``resilience.server_restore``,
    ``resilience.plane_reset``, ``resilience.plane_break``)."""

    VERBS = ("reset", "add_keys", "tree_init", "tree_crawl", "tree_crawl_last",
             "tree_prune", "tree_prune_last", "final_shares", "warmup", "status",
             "tree_checkpoint", "tree_restore", "plane_reset", "plane_break")

    def __init__(self, server_id: int, cfg: Config, device=None, *, ckpt_dir=None,
                 emit=None):
        if server_id not in (0, 1):
            raise ValueError(f"server_id must be 0 or 1, got {server_id}")
        if cfg.server_data_devices > 1:
            raise not_ported(f"server_data_devices={cfg.server_data_devices}",
                              "a collector server sharded over several cards")
        self.server_id = server_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self.boot_id = secrets.token_hex(8)
        self.ckpt_dir = ckpt_dir
        self.emit = emit or (lambda event, **kw: None)
        # run report: seconds per phase, bytes per plane and the largest
        # data-plane frame, crawl verbs begun and finished, add_keys chunks,
        # replays answered from the cache, plane resets, checkpoints written
        # (bytes, seconds) and restored (seconds)
        self.stats = {"seconds": dict.fromkeys(PHASES, 0.0),
                      "data_bytes_sent": 0, "data_bytes_recv": 0, "data_frame_max": 0,
                      "control_bytes_sent": 0, "control_bytes_recv": 0, "levels": 0,
                      "levels_done": 0, "add_keys": 0, "dedup_hits": 0, "plane_resets": 0,
                      "ckpt_writes": 0, "ckpt_bytes": 0, "ckpt_write_s": 0.0, "restores": 0,
                      "restore_s": 0.0}
        # every verb but add_keys and plane_break runs under it
        self._verb_lock = asyncio.Lock()
        self._sessions: dict = {}  # leader session id -> _Session
        self._peer_addr = None  # server 0: where it dials the plane
        self._peer_reader = self._peer_writer = None
        self._rpc_srv = self._peer_srv = None
        self._ctl_writers: set = set()
        self._plane_keyed = False  # the handshake below ran on this data plane
        self._ot_snd = self._ot_rcv = None  # extension sender (garbler) / receiver
        self._sec_seed = None  # per-level GC and b2a seeds
        self._crawl_ctr = 0
        self._clear()

    def _clear(self) -> None:
        self.keys_parts: list = []  # uploaded numpy key chunks
        self.keys = None  # IbDcfKeyBatch [N, d, 2] on the device
        self.alive_keys = None
        self.frontier = None
        self.children = None  # the child cache of this level's crawl
        self.last_shares = None  # surviving leaves' F255 shares
        self._clear_spans()

    def _clear_spans(self) -> None:
        self._shard_children: dict = {}  # span lo -> child cache of this level
        self._shard_last: dict = {}  # span lo -> last-level shares
        self._shard_level = None
        self._expand_ready: dict = {}  # (last, level, span) -> pre-expanded stage
        self._mask_cache = None  # ((level, F, f255), the whole level's mask rows)

    def _count(self, key: str):
        def add(n: int) -> None:
            self.stats[key] += n
            if key.startswith("data_"):
                self.stats["data_frame_max"] = max(self.stats["data_frame_max"], n)
        return add

    # -- verbs ----------------------------------------------------------------

    async def reset(self, _req) -> bool:
        self._clear()
        self._ckpt_clear()  # a new collection must not resume an old one's
        if self._ot_snd is not None:  # fresh GC/b2a randomness per collection
            self._sec_seed = np.frombuffer(secrets.token_bytes(16), "<u4").copy()
        return True

    async def add_keys(self, req) -> bool:
        """Append one key chunk: the five leaves of a [B, d, 2] batch."""
        if req.get("sketch") is not None:
            raise not_ported("add_keys", "the malicious sketch material")
        self.stats["add_keys"] += 1
        self.keys_parts.append(tuple(np.asarray(a) for a in req["keys"]))
        return True

    def _concat_keys(self, verb: str) -> None:
        """The uploaded chunks as one key batch on the device, checked
        against the crawl radix."""
        if not self.keys_parts and self.keys is None:
            raise RuntimeError(f"{verb} before add_keys")
        if self.keys_parts:
            leaves = [np.concatenate(p) for p in zip(*self.keys_parts)]
            self.keys_parts = []
            self.keys = ibdcf.keys_from_numpy(ibdcf.IbDcfKeyBatch(*leaves), self.device)
        d = self.keys.cw_seed.shape[1]
        if not 1 <= d <= collect.MAX_DIMS:
            raise ValueError(f"n_dims={d}: supported 1..{collect.MAX_DIMS}")
        collect.check_radix(d, self.cfg.crawl_radix_bits)

    def _keys_fp(self) -> np.ndarray:
        """uint8[32]: SHA-256 over ``key_idx`` then ``root_seed`` in their
        wire dtypes, byte for byte the JAX server's ``keys_fp``: did the
        leader re-upload the batch this checkpoint was written under (an
        operational check, not a cryptographic one)."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.keys.key_idx.cpu().numpy()))
        h.update(np.ascontiguousarray(words_to_numpy(self.keys.root_seed)))
        return np.frombuffer(h.digest(), np.uint8)

    def crawl_radix(self, level: int) -> int:
        """Bit levels of the crawl round based at ``level``: the server's
        radix, clipped at the tail of the key batch's data_len."""
        return min(self.cfg.crawl_radix_bits, self.keys.cw_seed.shape[-2] - int(level))

    async def tree_init(self, req) -> bool:
        if not self.keys_parts and self.keys is None:
            raise RuntimeError("tree_init before add_keys")
        await self._ensure_plane()
        self._concat_keys("tree_init")
        n = self.keys.cw_seed.shape[0]
        self.alive_keys = torch.ones(n, dtype=torch.bool, device=self.device)
        self.frontier = collect.tree_init(self.keys, int((req or {}).get("root_bucket", 1)))
        self.children = self.last_shares = None
        self._clear_spans()
        return True

    async def tree_crawl(self, req) -> np.ndarray:
        """-> FE62 shares uint64[F, 2^d] of the per-child counts (rpc.rs:60)."""
        return await self._crawl("tree_crawl", req, last=False)

    async def tree_crawl_last(self, req) -> np.ndarray:
        """-> F255 shares uint32[F, 2^d, 8] of the last level (rpc.rs:61),
        kept for ``tree_prune_last`` and ``final_shares``; a span's shares
        are banked for ``tree_prune_last`` to assemble."""
        shares = await self._crawl("tree_crawl_last", req, last=True)
        shard = self._parse_shard(req)
        if shard is None:
            self.last_shares = shares
        else:
            self.last_shares = None
            self._shard_last[shard[0]] = shares
        return shares

    async def tree_prune(self, req) -> bool:
        """Fused prune + advance: the surviving children, gathered from this
        round's child cache (ref: rpc.rs:63, collect.rs:918-929), assembled
        from its spans when the round was crawled in spans.  A prune with no
        cache re-expands the round's r bits first."""
        if self.frontier is None:
            raise RuntimeError("tree_prune before tree_init")
        level = int(req["level"])
        parent, pat, n_alive = self._prune_args(req)
        r = pat.shape[1]
        if r != self.crawl_radix(level):
            raise RuntimeError(
                f"prune pattern carries {r} step bit(s) where this session's level-{level} "
                f"round fuses {self.crawl_radix(level)} (crawl_radix_bits mismatch between "
                "leader and server?)")
        self._expand_ready.clear()  # the frontier is about to change
        if self.children is None and self._shard_children:
            self.children = self._assemble_shard_children(r)
        children = self.children
        if children is None:
            _, children = collect.expand_share_bits_radix(self.keys, self.frontier, level, r,
                                                          want_children=True)
        dev = self.device
        self.frontier = collect.advance_from_children_radix(
            children, torch.from_numpy(parent).to(dev), torch.from_numpy(pat).to(dev),
            n_alive, r)
        self.children = None
        return True

    async def tree_prune_last(self, req) -> bool:
        """Compact the last level's shares to the survivors
        (ref: collect.rs:931-942)."""
        self._expand_ready.clear()
        if self.last_shares is None and self._shard_last:
            whole = np.concatenate([p for _, p in sorted(self._shard_last.items())], axis=0)
            if whole.shape[0] != self.frontier.f_bucket:
                raise RuntimeError(f"sharded last crawl incomplete: shares cover "
                                   f"{whole.shape[0]} of {self.frontier.f_bucket} slots")
            self.last_shares = whole
            self._shard_last.clear()
        if self.last_shares is None:
            raise RuntimeError("tree_prune_last called before tree_crawl_last")
        self.children = None
        parent, pat, n_alive = self._prune_args(req)
        _, r, d = pat.shape
        base = self.keys.cw_seed.shape[-2] - r
        if r != self.crawl_radix(base):
            raise RuntimeError(f"leaf prune pattern carries {r} step bit(s) where this "
                               f"session's tail round fuses {self.crawl_radix(base)}")
        # the step-major fused leaf id
        shift = np.arange(r)[:, None] * d + np.arange(d)[None, :]
        child = (pat[:n_alive].astype(np.int64) << shift).sum(axis=(1, 2))
        self.last_shares = self.last_shares[parent[:n_alive], child]
        return True

    async def final_shares(self, _req) -> dict:
        """The surviving leaves' count shares (ref: rpc.rs:65)."""
        return {"server_id": self.server_id, "shares": self.last_shares}

    async def warmup(self, req) -> dict:
        """Run, for every requested bucket ``f_buckets`` and every span size
        it implies under ``crawl_shard_nodes`` (none for a whole-level
        secure crawl unless ``secure_spans``), what a crawl at that bucket
        runs (:meth:`_warm_bucket`), with the leader's ``ot_path``.  Touches
        no live state: neither the frontier, nor the OT sessions, nor the
        data plane.  -> ``{"shapes", "ladder_hits"}`` (the hits of the JAX
        server's tenant ladder, always 0: tenancy is not ported)."""
        self._concat_keys("warmup")
        req = req or {}
        buckets = sorted({int(b) for b in req.get("f_buckets", []) if int(b) > 0})
        ot_path = req.get("ot_path") or self.cfg.ot_path
        whole = (self.cfg.secure_exchange and self.cfg.secure_whole_level
                 and not req.get("secure_spans"))
        L = self.keys.cw_seed.shape[-2]
        shapes = 0
        for b in buckets:
            sizes = set() if whole else {
                hi - lo for lo, hi in collect.shard_spans(b, self.cfg.crawl_shard_nodes)}
            for fb in sorted(sizes | {b}):
                self._warm_bucket(fb, L, ot_path)
                shapes += 1
                await asyncio.sleep(0)  # the control plane keeps answering
        if self.device.type == "cuda":  # the peer process shares the card
            torch.cuda.empty_cache()
        return {"shapes": shapes, "ladder_hits": 0}

    def _warm_bucket(self, fb: int, L: int, ot_path: str) -> None:
        """A throwaway root frontier of ``fb`` slots through the rounds a
        crawl runs: the full-radix round with the child cache and the tail
        round without (one round when it is the whole crawl); then the
        count, or in secure mode the level's whole 2PC chain
        (``secure.warm_level_kernels``) in FE62 or, for the tail, F255."""
        d = self.keys.cw_seed.shape[1]
        k = self.cfg.crawl_radix_bits
        fr = collect.tree_init(self.keys, fb)
        base_last = k * ((L - 1) // k)
        steps = ([(min(k, L), True)] if base_last == 0
                 else [(k, False), (L - base_last, True)])
        alive = self.alive_keys
        if alive is None:
            alive = torch.ones(self.keys.cw_seed.shape[0], dtype=torch.bool, device=self.device)
        for r, last in steps:
            # the child cache is dropped at once: the tail round is built without it
            packed = collect.expand_share_bits_radix(
                self.keys, fr, base_last if last else 0, r, want_children=not last)[0]
            if self.cfg.secure_exchange:
                secure.warm_level_kernels(packed, d, F255 if last else FE62, ot_path, r)
            else:
                collect.counts_by_pattern(packed, packed, collect.pattern_masks_radix(d, r),
                                          alive, fr.alive).cpu()

    # -- recovery verbs (no reference analogue: its only recovery verb is
    # reset, server.rs:64-69) ------------------------------------------------

    async def status(self, _req) -> dict:
        """The supervising leader's probe: the boot id tells it whether this
        is the process it knew (replay is safe) or a restart (state gone:
        restore), the dedup hits that no verb ran twice.  The JAX server's
        sections of unported layers (ingest, sessions, fleet, slo, alerts)
        are left out; ``mesh`` is None, as on a one-card JAX server."""
        return {"boot_id": self.boot_id, "collection": DEFAULT_COLLECTION,
                "clock": round(time.time(), 6),
                "has_keys": self.keys is not None or bool(self.keys_parts),
                "has_frontier": self.frontier is not None,
                "dedup_hits": self.stats["dedup_hits"],
                "plane_resets": self.stats["plane_resets"],
                "ckpt_levels": self._ckpt_levels(), "mesh": None}

    async def tree_checkpoint(self, req) -> dict:
        """Persist the crawl state after the round based at ``level``: the
        frontier (plane-major: ``planar`` True), node and client liveness,
        stamped with the key fingerprint, the level, the collection
        (``sess``) and the crawl radix — the JAX server's blob, field for
        field.  Keys are not in it: the leader re-uploads them to a
        restarted server.  Written to a temporary file and renamed, so a
        crash mid-write leaves the previous checkpoint whole; the two
        newest levels are kept."""
        if self.ckpt_dir is None:
            raise RuntimeError("tree_checkpoint: no checkpoint dir configured "
                               "(start the server with FHH_CKPT_DIR set)")
        if self.frontier is None:
            raise RuntimeError("tree_checkpoint before tree_init")
        level = int(req["level"])
        t0 = time.perf_counter()
        st = self.frontier.states
        as_np = lambda t: t.cpu().numpy()
        blob = {"seed": words_to_numpy(st.seed), "bit": as_np(st.bit),
                "y_bit": as_np(st.y_bit), "alive": as_np(self.frontier.alive),
                "alive_keys": as_np(self.alive_keys), "planar": np.bool_(True),
                "keys_fp": self._keys_fp(), "level": np.int64(level),
                "sess": np.str_(DEFAULT_COLLECTION),
                "radix": np.int64(self.cfg.crawl_radix_bits)}
        path = self._ckpt_path(level)
        tmp = f"{path}.tmp{os.getpid()}"

        def write():
            with open(tmp, "wb") as f:
                np.savez(f, **blob)
            os.replace(tmp, path)
            self._ckpt_prune()

        await asyncio.to_thread(write)
        dt = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        self.stats["ckpt_writes"] += 1
        self.stats["ckpt_bytes"] += nbytes
        self.stats["ckpt_write_s"] += dt
        self.emit("resilience.server_checkpoint", server=self.server_id,
                  collection=DEFAULT_COLLECTION, level=level, path=path, bytes=nbytes,
                  seconds=dt)
        return {"level": level}

    async def tree_restore(self, req) -> dict:
        """Reload the :meth:`tree_checkpoint` of the level the leader names
        and return it (the crawl goes on at the round after it).  Needs the
        keys: still held, or re-uploaded after a restart.  Every check runs
        before any state changes — a missing, corrupt or truncated file,
        another collection's or crawl radix's stamp, missing fields, another
        key batch, a file renamed to another level, a level past the tree,
        another client count — and a refusal leaves the live state as it
        was.  A blob of the interleaved layout (``planar`` False, a JAX
        server on the XLA engine) is carried to the plane-major one."""
        if self.ckpt_dir is None:
            raise RuntimeError("tree_restore: no checkpoint dir configured")
        want = int(req["level"])
        path = self._ckpt_path(want)
        if not os.path.exists(path):
            raise RuntimeError(f"tree_restore: no checkpoint at {path}")
        t0 = time.perf_counter()
        try:  # a torn write surfaces as BadZipFile, ValueError or EOFError
            z = await asyncio.to_thread(_load_npz, path)
        except Exception as e:  # every load failure is the same refusal
            raise RuntimeError(f"tree_restore: corrupt or truncated checkpoint at {path} "
                               f"({type(e).__name__}: {e})") from e
        if "sess" in z and str(z["sess"]) != DEFAULT_COLLECTION:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is stamped for collection "
                               f"{str(z['sess'])!r}, not {DEFAULT_COLLECTION!r} (renamed across "
                               "session namespaces?)")
        saved_radix = int(z["radix"]) if "radix" in z else 1  # unstamped blobs are radix 1
        if saved_radix != self.cfg.crawl_radix_bits:
            raise RuntimeError(f"tree_restore: checkpoint at {path} was written under "
                               f"crawl_radix_bits={saved_radix}; this session runs "
                               f"crawl_radix_bits={self.cfg.crawl_radix_bits} — its level grid "
                               "never visits the blob's frontier depth")
        if "ing_only" in z or "sk_root" in z:
            raise not_ported(f"tree_restore of {path}", "streaming ingestion" if "ing_only" in z
                             else "the malicious sketch material")
        self._concat_keys("tree_restore")
        required = {"seed", "bit", "y_bit", "alive", "alive_keys", "level", "planar",
                    "keys_fp"}
        missing = required - set(z)
        if missing:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is missing fields "
                               f"{sorted(missing)} (truncated write?)")
        if not np.array_equal(z["keys_fp"], self._keys_fp()):
            raise RuntimeError("tree_restore: checkpoint was written under a different key "
                               "batch — re-upload the original keys")
        level = int(z["level"])
        L, n = self.keys.cw_seed.shape[-2], self.keys.cw_seed.shape[0]
        if level != want:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is stamped level {want} "
                               f"but records level {level} (renamed or tampered file)")
        if level >= L - 1:
            raise RuntimeError(f"tree_restore: checkpoint level {level} is deeper than this "
                               f"key batch's tree (data_len={L}) — wrong collection")
        if z["alive_keys"].shape[0] != n:
            raise RuntimeError("tree_restore: checkpoint client count != key batch")
        # -- every check passed: mutate
        dev = self.device
        as_bool = lambda a: tensor_from_numpy(a, dev, bool)
        if bool(z["planar"]):
            states = EvalState(seed=words_from_numpy(z["seed"], dev), bit=as_bool(z["bit"]),
                               y_bit=as_bool(z["y_bit"]))
        else:
            states = collect.states_from_numpy(
                EvalState(seed=z["seed"], bit=z["bit"], y_bit=z["y_bit"]), dev)
        self.alive_keys = as_bool(z["alive_keys"])
        self.frontier = collect.Frontier(states=states, alive=as_bool(z["alive"]))
        self.children = self.last_shares = None
        self._clear_spans()
        dt = time.perf_counter() - t0
        self.stats["restores"] += 1
        self.stats["restore_s"] += dt
        self.emit("resilience.server_restore", server=self.server_id,
                  collection=DEFAULT_COLLECTION, level=level, seconds=dt,
                  planar=bool(z["planar"]))
        return {"level": level}

    async def plane_reset(self, _req) -> bool:
        """Re-establish the data plane after a peer loss: server 0 drops its
        transport and redials under ``DIAL_POLICY``; server 1 re-accepts on
        its listener, which is still bound.  The next data-plane verb on
        each side re-keys the new transport."""
        if self.server_id != 0:
            return True
        if self._peer_writer is not None and not self._peer_writer.is_closing():
            self._peer_writer.close()
        await self._dial_peer()
        self.stats["plane_resets"] += 1
        self.emit("resilience.plane_reset", server=self.server_id)
        return True

    async def plane_break(self, _req) -> bool:
        """Close this server's end of the data plane without redialing: the
        pipelined leader's quiesce.  Dispatched outside the verb lock, so it
        can break a verb wedged on a plane recv while holding that lock (a
        span that reached one server only): the recv fails, the verb answers
        its error, and the leader's ``plane_reset`` follows."""
        w = self._peer_writer
        if w is not None and not w.is_closing():
            w.close()
        self.emit("resilience.plane_break", server=self.server_id)
        return True

    # -- the checkpoint namespace (the JAX default collection's names) --------

    def _ckpt_prefix(self) -> str:
        return f"fhh_server{self.server_id}_l"

    def _ckpt_path(self, level: int) -> str:
        # level-stamped: a torn round (one server wrote level k, the other
        # died first) leaves both able to restore the same earlier level
        return os.path.join(self.ckpt_dir, f"{self._ckpt_prefix()}{level}.npz")

    def _ckpt_found(self) -> list:
        """[(level, file name)] of this server's checkpoints, in numeric
        level order (a string sort puts l10 before l9)."""
        if self.ckpt_dir is None or not os.path.isdir(self.ckpt_dir):
            return []
        prefix, found = self._ckpt_prefix(), []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith(prefix) and name.endswith(".npz"):
                try:
                    found.append((int(name[len(prefix):-4]), name))
                except ValueError:
                    continue
        return sorted(found)

    def _ckpt_levels(self) -> list:
        return [lvl for lvl, _ in self._ckpt_found()]

    def _ckpt_prune(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` checkpoint levels (``keep`` 0:
        all of them)."""
        found = self._ckpt_found()
        for _, name in found[:len(found) - keep] if keep else found:
            os.remove(os.path.join(self.ckpt_dir, name))

    def _ckpt_clear(self) -> None:
        self._ckpt_prune(keep=0)

    @staticmethod
    def _prune_args(req):
        """(parent_idx int64[F'], pattern bits bool[F', r, d], n_alive): the
        wire's ``[F', d]`` (radix 1) or ``[F', r, d]`` (a fused round)."""
        parent = np.asarray(req["parent_idx"], np.int64)
        pat = np.asarray(req["pattern_bits"], bool)
        if pat.ndim == 2:
            pat = pat[:, None, :]
        if pat.ndim != 3:
            raise ValueError(f"pattern bits shaped {list(pat.shape)}: want [F', d] or "
                             "[F', r, d]")
        return parent, pat, int(req["n_alive"])

    # -- node spans -----------------------------------------------------------

    @staticmethod
    def _parse_shard(req):
        s = (req or {}).get("shard")
        return None if s is None else (int(s[0]), int(s[1]))

    def _frontier_view(self, shard):
        if shard is None:
            return self.frontier
        return collect.frontier_slice(self.frontier, *shard)

    def _stash_children(self, level: int, shard, children) -> None:
        """Bank one crawl's child cache for the prune: the whole level's,
        or a span's under its ``lo`` (the first span of a new level drops
        any stale ones)."""
        if shard is None:
            self.children = children
            return
        if self._shard_level != level:
            self._shard_children.clear()
            self._shard_last.clear()
            self._shard_level = level
        self.children = None
        if children is not None:
            self._shard_children[shard[0]] = children

    def _assemble_shard_children(self, radix: int):
        """The round's child cache from its spans (``2^(radix-1)`` cache
        rows per frontier slot); a missing span raises rather than advance
        garbage for its nodes."""
        children = collect.children_cat(list(self._shard_children.items()))
        got = children.seed.shape[4] >> (radix - 1)
        if got != self.frontier.f_bucket:
            raise RuntimeError(f"sharded crawl incomplete: child caches cover {got} of "
                               f"{self.frontier.f_bucket} frontier slots")
        self._shard_children.clear()
        return children

    def _mask_rows(self, level: int, shard, C: int, f255: bool) -> np.ndarray:
        """The trusted answer's mask rows of one (level, span): the whole
        level's stream sliced to the span's nodes (one-entry cache)."""
        F = self.frontier.f_bucket
        key = (level, F, f255)
        if self._mask_cache is None or self._mask_cache[0] != key:
            self._mask_cache = (key, sessions.mask_rows(level, F, C, f255))
        full = self._mask_cache[1]
        return full if shard is None else full[shard[0]:shard[1]]

    def _do_expand(self, level: int, last: bool, shard) -> dict:
        """The device half of one crawl verb: the expansion of the frontier
        view (and in secure mode its equality strings).  Dispatches device
        work and never touches the data plane."""
        frontier = self._frontier_view(shard)
        r = self.crawl_radix(level)
        packed, children = collect.expand_share_bits_radix(self.keys, frontier, level, r,
                                                           want_children=not last)
        out = {"packed": packed, "children": children, "frontier": frontier}
        if self.cfg.secure_exchange:  # strings of S' = 2·d·r bits
            strs = secure.child_strings_radix(packed, self.keys.cw_seed.shape[1], r)
            F, C, N, S = strs.shape
            out.update(flat=strs.reshape(F * C * N, S), dims=(F, C, N, S))
            del out["packed"]
        return out

    def _expand_stage(self, level: int, last: bool, shard) -> dict:
        hit = self._expand_ready.pop((last, level, shard), None)
        return hit if hit is not None else self._do_expand(level, last, shard)

    def _maybe_pre_expand(self, verb: str, req) -> None:
        """Frame arrival of a span's crawl verb, before the verb lock: run
        its expansion now, while an earlier span holds the lock on the data
        plane.  A prefetch only: any failure here leaves the verb to
        recompute, and surface the error, under the lock."""
        if verb not in ("tree_crawl", "tree_crawl_last"):
            return
        shard = self._parse_shard(req)
        if shard is None or self.keys is None or self.frontier is None:
            return
        if shard[1] > self.frontier.f_bucket:
            return
        key = (verb == "tree_crawl_last", int(req["level"]), shard)
        if key in self._expand_ready or len(self._expand_ready) >= 32:
            return
        t0 = time.perf_counter()
        try:
            self._expand_ready[key] = self._do_expand(key[1], key[0], shard)
        except Exception:  # prefetch only: the verb recomputes and reports
            self._expand_ready.pop(key, None)
            return
        self._phases(fss=time.perf_counter() - t0)

    # -- one level ------------------------------------------------------------

    async def _crawl(self, verb: str, req, last: bool) -> np.ndarray:
        if self.frontier is None:
            raise RuntimeError(f"{verb} before tree_init")
        level = int(req["level"])
        shard = self._parse_shard(req)
        await self._ensure_plane()
        field = F255 if last else FE62
        self.stats["levels"] += 1
        if self.cfg.secure_exchange:
            shares = await self._crawl_secure(level, field, last, int(req.get("garbler", 0)),
                                              req.get("ot_path"), shard)
            self.stats["levels_done"] += 1
            return shares
        counts = await self._crawl_trusted(level, last, shard)
        self.stats["levels_done"] += 1
        # trusted mode: both servers hold these counts; the shared mask is a
        # wire-format shim for the leader's v0 - v1, not a secret
        F, C = counts.shape
        r = self._mask_rows(level, shard, C, f255=last)
        if self.server_id == 1:
            return r
        if last:
            c = np.zeros((F, C, 8), np.uint32)
            c[..., 0] = counts
            return F255.np_add(c, r)
        return FE62.np_add(counts.astype(np.uint64), r)

    def _phases(self, **seconds) -> None:
        for k, v in seconds.items():
            self.stats["seconds"][k] += v

    async def _crawl_trusted(self, level: int, last: bool, shard) -> np.ndarray:
        """Swap the packed share bits uint32[F, N] of the frontier (or the
        span) with the peer and count -> int64[F, 2^(d·r)] (ref:
        collect.rs:945-964)."""
        t0 = time.perf_counter()
        ex = self._expand_stage(level, last, shard)
        packed, frontier = ex["packed"], ex["frontier"]
        mine = await _fetch_words(packed)
        t1 = time.perf_counter()
        peer = await self._swap(mine)
        t2 = time.perf_counter()
        if peer.shape != mine.shape:
            raise RuntimeError(f"level {level}: the peer's share bits are shaped "
                               f"{peer.shape}, this server's {mine.shape}")
        dev_counts = collect.counts_by_pattern(
            packed, words_from_numpy(peer, self.device),
            collect.pattern_masks_radix(self.keys.cw_seed.shape[1], self.crawl_radix(level)),
            self.alive_keys,
            frontier.alive)
        counts = await asyncio.to_thread(lambda: dev_counts.cpu().numpy())
        self._stash_children(level, shard, ex["children"])
        self._phases(fss=t1 - t0, gc_ot=t2 - t1, field=time.perf_counter() - t2)
        return counts

    async def _crawl_secure(self, level: int, field, last: bool, garbler: int,
                            ot_path, shard) -> np.ndarray:
        """The whole-level (or span) 2PC (ref: collect.rs:419-501): the
        evaluator sends its extension's ``u``, the garbler answers with its
        one planar message, each server sums its additive shares per (node,
        pattern).  No share bit crosses the wire."""
        dev = self.device
        clock = PhaseClock(dev)
        t0 = time.perf_counter()
        ex = self._expand_stage(level, last, shard)
        flat = ex["flat"]
        F, C, N, S = ex["dims"]
        B = F * C * N
        w = secure.alive_weight(ex["frontier"].alive, self.alive_keys, C)
        # the crawl counter keeps every garbling's randomness fresh if a leader
        # re-crawls a level without a reset
        self._crawl_ctr += 1
        gseed = secure.derive_seed(self._sec_seed, 1, level, self._crawl_ctr)
        bseed = secure.derive_seed(self._sec_seed, 2, level, self._crawl_ctr)
        path = secure.ot_path(S, ot_path or self.cfg.ot_path)
        t1 = time.perf_counter()
        if self.server_id == garbler:  # garbler = OT-extension sender
            u = words_from_numpy(await self._dp_recv(), dev)
            msg, vals = secure.gb_step_level(self._ot_snd, u, flat, gseed, bseed, field,
                                             garbler, path, phase=clock)
            del u
            await self._dp_send(await _fetch_words(msg))
            del msg
        else:  # evaluator = OT-extension receiver
            u, t_rows, idx0 = secure.ev_step1_fused(self._ot_rcv, flat, phase=clock)
            await self._dp_send(await _fetch_words(u))
            del u
            msg = words_from_numpy(await self._dp_recv(), dev)
            vals = secure.ev_open_level(t_rows, flat, msg, B, S, field, idx0, path,
                                        phase=clock)
            del t_rows, msg
        del flat, ex["flat"]
        t2 = time.perf_counter()
        sh = secure.node_share_sums(field, vals.reshape((F, C, N) + field.limb_shape), w)
        del vals
        shares = await asyncio.to_thread(_share_wire, field, sh)
        self._stash_children(level, shard, ex["children"])
        self._phases(fss=t1 - t0, gc_ot=t2 - t1, field=time.perf_counter() - t2,
                     **clock.settle())
        return shares

    # -- data plane -----------------------------------------------------------

    async def _dp_send(self, obj) -> None:
        await _send(self._peer_writer, (DEFAULT_COLLECTION, obj),
                    count=self._count("data_bytes_sent"))

    async def _dp_recv(self):
        frame = await _recv(self._peer_reader, count=self._count("data_bytes_recv"))
        if frame[0] != DEFAULT_COLLECTION:
            raise not_ported(f"a data-plane frame on channel {frame[0]!r}",
                              "the multi-tenant collection layer")
        return frame[1]

    async def _swap(self, obj):
        """Role-ordered exchange: server 0 writes first, server 1 reads
        first (symmetric send-then-recv deadlocks once frames outgrow the
        socket buffers)."""
        if self.server_id == 0:
            await self._dp_send(obj)
            return await self._dp_recv()
        peer = await self._dp_recv()
        await self._dp_send(obj)
        return peer

    async def _ensure_plane(self) -> None:
        """Key the current data plane once: the coin flip, then in secure
        mode the base-OT sessions (rpc.py:3144-3216 of the JAX package).  A
        new transport (:meth:`_attach_plane`) is keyed anew by the next
        data-plane verb on each side."""
        if self._plane_keyed:
            return
        # the coin flip seeds the JAX server's sketch challenge; the port has
        # no sketch yet, but a JAX peer sends and awaits this frame
        await self._swap(secrets.token_bytes(16))
        if self.cfg.secure_exchange:
            await self._setup_secure()
        self._plane_keyed = True

    async def _setup_secure(self) -> None:
        """Two base-OT sessions seeding the IKNP extension, one per garbling
        direction: in session ``g`` server ``g`` is the extension sender and
        plays base-OT receiver with its secret ``s``.  The elliptic-curve
        work runs off the event loop."""
        for g in (0, 1):
            if self.server_id == g:
                s_bits = otext.fresh_s_bits()
                a_msg = await self._dp_recv()
                br = baseot.BaseOtReceiver(s_bits)
                await self._dp_send(await asyncio.to_thread(br.round1, a_msg))
                seeds = await asyncio.to_thread(br.seeds)
                self._ot_snd = otext.OtExtSender(s_bits, seeds, self.device)
            else:
                bs = baseot.BaseOtSender()
                await self._dp_send(bs.round1())
                r_msgs = await self._dp_recv()
                s0, s1 = await asyncio.to_thread(
                    lambda: bs.seeds([baseot.decompress(m) for m in r_msgs]))
                self._ot_rcv = otext.OtExtReceiver(s0, s1, self.device)
        self._sec_seed = np.frombuffer(secrets.token_bytes(16), "<u4").copy()

    # -- serving --------------------------------------------------------------

    async def _run_verb(self, verb: str, req):
        """Run one verb; every failure is a response.  ``add_keys`` (it
        appends and never suspends) and ``plane_break`` (it must reach a
        verb wedged on the plane while holding the lock) run without the
        verb lock."""
        try:
            if verb in UNPORTED_VERBS:
                raise not_ported(verb, UNPORTED_VERBS[verb])
            if verb not in self.VERBS:
                raise ValueError(f"unknown verb {verb!r}")
            if verb in ("add_keys", "plane_break"):
                return await getattr(self, verb)(req)
            self._maybe_pre_expand(verb, req)
            async with self._verb_lock:
                return await getattr(self, verb)(req)
        except Exception as e:  # the RPC boundary: every failure goes to the caller
            _log.warning("server %d: verb %s failed: %s: %s", self.server_id, verb,
                         type(e).__name__, e)
            return {"__error__": f"{type(e).__name__}: {e}"}

    async def _dispatch(self, sess: _Session | None, req_id, verb: str, req):
        """Run one verb at most once per (session, request id): a replay of
        a finished request is answered from the session's cache, a replay of
        one still running awaits the same execution.  Errors are responses
        too, so a rejection replays as the same rejection.  A connection
        that never said hello has no session and no dedup."""
        if sess is not None:
            sess.last_seen = time.monotonic()
            if req_id in sess.cache:
                self.stats["dedup_hits"] += 1
                sess.cache.move_to_end(req_id)
                return sess.cache[req_id]
            live = sess.inflight.get(req_id)
            if live is not None:
                self.stats["dedup_hits"] += 1
                return await asyncio.shield(live)
            done = sess.inflight[req_id] = asyncio.get_running_loop().create_future()
        try:
            resp = await self._run_verb(verb, req)
        except asyncio.CancelledError:  # release any replay awaiting this execution
            if sess is not None:
                sess.inflight.pop(req_id, None)
                if not done.done():
                    done.cancel()
            raise
        if sess is not None:
            sess.put(req_id, resp)
            sess.inflight.pop(req_id, None)
            if not done.done():
                done.set_result(resp)
        return resp

    def _hello(self, req) -> dict:
        coll = (req or {}).get("collection") or DEFAULT_COLLECTION
        if coll != DEFAULT_COLLECTION:
            e = not_ported(f"__hello__ for collection {coll!r}",
                            "the multi-tenant collection layer")
            return {"__error__": f"{type(e).__name__}: {e}"}
        return {"boot_id": self.boot_id, "server_id": self.server_id,
                "collection": DEFAULT_COLLECTION, "clock": round(time.time(), 6)}

    def _bind_session(self, req) -> _Session | None:
        """Create or attach the leader session a ``__hello__`` names; the
        oldest idle one makes room past ``_SESSION_CAP``."""
        sid = (req or {}).get("session")
        if sid is None:
            return None
        sess = self._sessions.get(sid)
        if sess is None:
            while len(self._sessions) >= _SESSION_CAP:
                del self._sessions[min(self._sessions,
                                       key=lambda k: self._sessions[k].last_seen)]
            sess = self._sessions[sid] = _Session()
        sess.last_seen = time.monotonic()
        return sess

    async def _handle_leader(self, reader, writer) -> None:
        """Control-plane serve loop: every request runs as its own task, so
        many ``add_keys`` chunks are in flight at once; responses carry the
        request id.  A ``__hello__`` binds the connection to its leader's
        session (:meth:`_dispatch`).  On disconnect the verbs in flight
        finish (a verb mid-exchange must not leave the peer's frame unread)
        and their answers stay in the session's cache for the replay on
        the next connection."""
        write_lock = asyncio.Lock()
        self._ctl_writers.add(writer)
        sess = None

        async def respond(req_id, resp):
            try:
                async with write_lock:
                    await _send(writer, (req_id, resp), count=self._count("control_bytes_sent"))
            except ConnectionError:
                pass  # leader gone; the verb itself has finished
            except RuntimeError:
                if not writer.is_closing():  # asyncio's write on a closing transport
                    raise

        async def handle(sess, req_id, verb, req):
            await respond(req_id, await self._dispatch(sess, req_id, verb, req))

        tasks: set = set()
        try:
            while True:
                req_id, verb, req = await _recv(reader, count=self._count("control_bytes_recv"))
                if verb == "__hello__":
                    resp = self._hello(req)
                    if "__error__" not in resp:
                        sess = self._bind_session(req)
                    await respond(req_id, resp)
                    continue
                t = asyncio.create_task(handle(sess, req_id, verb, req))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            if tasks:
                await asyncio.wait(set(tasks))
            writer.close()
            self._ctl_writers.discard(writer)

    def _attach_plane(self, reader, writer) -> None:
        """Bind a new peer transport (closing the one it replaces): the next
        data-plane verb keys it anew, the coin flip and in secure mode fresh
        base-OT sessions (a survivor that kept its old OT extension with a
        restarted peer would break the 2PC)."""
        old = self._peer_writer
        if old is not None and old is not writer and not old.is_closing():
            old.close()
        self._peer_reader, self._peer_writer = reader, writer
        _keepalive(writer)
        self._plane_keyed = False
        self._ot_snd = self._ot_rcv = None

    async def _dial_peer(self) -> None:
        """Server 0: dial the peer's data plane under ``DIAL_POLICY``."""
        peer_host, peer_port = self._peer_addr

        async def dial():
            return await asyncio.wait_for(asyncio.open_connection(peer_host, peer_port),
                                          respolicy.DIAL_TIMEOUT_S)

        try:
            r, w = await respolicy.retry_async(dial, respolicy.DIAL_POLICY)
        except respolicy.TRANSIENT_ERRORS as e:
            raise ConnectionError(
                f"peer data plane unreachable at {peer_host}:{peer_port}: {e!r}") from e
        self._attach_plane(r, w)

    async def start(self, host: str, port: int, peer_host: str, peer_port: int,
                    on_plane_listen=None):
        """Bring up the data plane first (server.rs:344-354: server 1
        listens on ``peer_port``, server 0 dials it under ``DIAL_POLICY``),
        then listen for the leader.  ``on_plane_listen`` is called once
        server 1 listens for its peer; a later dial (``plane_reset``)
        replaces its plane.  Returns the leader-facing server."""
        self._peer_addr = (peer_host, peer_port)
        if self.server_id == 1:
            ready = asyncio.Event()

            async def on_peer(reader, writer):
                self._attach_plane(reader, writer)
                ready.set()

            self._peer_srv = await asyncio.start_server(on_peer, host, peer_port)
            if on_plane_listen is not None:
                on_plane_listen()
            await ready.wait()  # as long as the peer takes to come up
        else:
            await self._dial_peer()
        self._rpc_srv = await asyncio.start_server(self._handle_leader, host, port)
        return self._rpc_srv

    async def aclose(self) -> None:
        """Close the listeners, the leader connections and the data plane
        (transports first: a listener's ``wait_closed`` waits for them)."""
        for w in list(self._ctl_writers):
            w.close()
        if self._peer_writer is not None:
            self._peer_writer.close()
        for srv in (self._rpc_srv, self._peer_srv):
            if srv is not None:
                srv.close()
                await srv.wait_closed()


class ServerRestartedError(ConnectionError):
    """The reconnect found another server process (a new boot id): its
    in-memory state is gone, so a replay is unsafe; the supervising leader
    restores instead (re-upload the keys, ``tree_restore``).  A
    ``ConnectionError``, so unsupervised callers see a lost connection."""


class CollectorClient:
    """The leader's stub of one server, reconnecting.  Request ids let any
    number of calls ride one connection (a reader task resolves them by
    id); ``__error__`` responses raise ``RuntimeError``.

    The client keeps one session id for its life and says ``__hello__
    {session, epoch}`` on every connect (``epoch`` counts connects).  A
    call keeps one request id for its life: after a transport loss it
    redials under ``dial_policy`` (one redial per epoch; calls that failed
    together ride it) and resends the same frame, which the server answers
    from its dedup cache if the verb already ran.  Two ways out besides an
    answer: the verb's budget (``budgets``) runs out (``TimeoutError``),
    or the hello finds a new boot id (:class:`ServerRestartedError`)."""

    def __init__(self, host: str, port: int, *, dial_policy=None, budgets=None):
        self._host, self._port = host, port
        self._r = self._w = None
        self._send_lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()
        self._pending: dict = {}
        self._next_id = 0
        self._reader_task = None
        self._dead: ConnectionError | None = None
        self.collection = DEFAULT_COLLECTION
        self.session_id = secrets.token_hex(8)
        self.epoch = 0  # connects so far; above 1 the client has reconnected
        self.boot_id = self.server_id = None  # from the last hello
        self.dial_policy = dial_policy or respolicy.DIAL_POLICY
        self.budgets = budgets or respolicy.VerbBudgets()
        self.stats = {"control_bytes_sent": 0, "control_bytes_recv": 0, "reconnects": 0,
                      "call_retries": 0}

    @classmethod
    async def connect(cls, host: str, port: int, **kw) -> "CollectorClient":
        c = cls(host, port, **kw)
        await c._ensure_connected(0)
        return c

    def _count(self, key: str):
        def add(n: int) -> None:
            self.stats[key] += n
        return add

    def _fail_pending(self, err: ConnectionError) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    async def _ensure_connected(self, seen_epoch: int) -> None:
        """(Re)dial unless another call already did since ``seen_epoch``,
        then say hello on the new connection."""
        if self._dead is not None:
            raise self._dead
        async with self._conn_lock:
            if self.epoch > seen_epoch and self._w is not None and not self._w.is_closing():
                return  # a concurrent call reconnected already

            async def dial():
                return await asyncio.wait_for(asyncio.open_connection(self._host, self._port),
                                              respolicy.DIAL_TIMEOUT_S)

            try:
                r, w = await respolicy.retry_async(dial, self.dial_policy)
            except respolicy.TRANSIENT_ERRORS as e:
                err = ConnectionError(f"server {self._host}:{self._port} unreachable: {e!r}")
                self._fail_pending(err)
                raise err from e
            if self._reader_task is not None:
                self._reader_task.cancel()
            if self._w is not None and not self._w.is_closing():
                self._w.close()  # the superseded transport
            # a call still waiting on the old transport never gets its answer
            # there: fail it, so that it replays on the new one
            self._fail_pending(ConnectionError("transport replaced by reconnect"))
            self._r, self._w = r, w
            self.epoch += 1
            self._reader_task = asyncio.ensure_future(self._read_loop(r))
            self._next_id += 1
            hello = await self._roundtrip(
                self._next_id, "__hello__",
                {"session": self.session_id, "epoch": self.epoch, "collection": self.collection},
                self.budgets.deadline("__hello__"))
            if isinstance(hello, dict) and "__error__" in hello:
                raise RuntimeError(f"hello refused by {self._host}:{self._port}: "
                                   f"{hello['__error__']}")
            self.boot_id, self.server_id = hello.get("boot_id"), hello.get("server_id")
            if self.epoch > 1:
                self.stats["reconnects"] += 1

    async def _read_loop(self, reader) -> None:
        try:
            while True:
                req_id, resp = await _recv(reader, count=self._count("control_bytes_recv"))
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(resp)
        except Exception as e:  # reader death fails every call in flight
            self._fail_pending(ConnectionError(
                f"connection to {self._host}:{self._port} lost: {e!r}"))

    async def _roundtrip(self, req_id, verb: str, req, deadline: respolicy.Deadline):
        """One send and its answer on the current transport, no retry."""
        if (self._w is None or self._w.is_closing() or self._reader_task is None
                or self._reader_task.done()):
            raise ConnectionError("transport down")  # fail fast into the redial
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            async with self._send_lock:
                await _send(self._w, (req_id, verb, req or {}),
                            count=self._count("control_bytes_sent"))
            return await deadline.wait_for(fut)
        finally:
            self._pending.pop(req_id, None)

    async def call(self, verb: str, req=None):
        """One verb, at most once, under its wall-clock budget: transient
        transport failures redial and resend the same request id; a server
        error raises ``RuntimeError``."""
        if self._dead is not None:
            raise self._dead
        deadline = self.budgets.deadline(verb)
        first_boot = self.boot_id
        self._next_id += 1
        req_id = self._next_id  # one id for the call's life: the server dedups replays
        while True:
            seen_epoch = self.epoch
            try:
                resp = await self._roundtrip(req_id, verb, req, deadline)
                break
            except respolicy.TRANSIENT_ERRORS as e:
                if deadline.expired():
                    raise TimeoutError(f"verb {verb!r} exceeded its "
                                       f"{self.budgets.budget(verb):g}s budget (last error: "
                                       f"{type(e).__name__}: {e})") from e
                self.stats["call_retries"] += 1
                await self._ensure_connected(seen_epoch)
                if first_boot is not None and self.boot_id != first_boot:
                    raise ServerRestartedError(
                        f"server {self._host}:{self._port} restarted while {verb!r} was in "
                        "flight — state lost, replay unsafe") from e
        if isinstance(resp, dict) and "__error__" in resp:
            raise RuntimeError(f"server error on {verb}: {resp['__error__']}")
        return resp

    async def aclose(self) -> None:
        self._dead = ConnectionError("client closed")
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._w is not None and not self._w.is_closing():
            self._w.close()
        self._fail_pending(self._dead)
