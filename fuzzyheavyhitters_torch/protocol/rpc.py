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
  ``(collection, payload)`` frames, demultiplexed into one FIFO channel a
  collection (``sessions.PlaneMux``); under tracing a third element, the
  sender's (trace id, span id), ties the receiver's arrival instant to the
  sender's span (JAX rpc.py:704-720).

The wire is the JAX package's, frame for frame: every payload is numpy
arrays of its dtypes (uint32 words, uint64 FE62 shares, uint32[..., 8] F255
shares, bool bits, int32 indices), Python scalars, dicts, tuples and bytes —
never a ``torch.Tensor`` (:func:`_send` refuses one) — so a JAX server can
pair with a port server, and either package's leader can drive either pair.

Per collection and plane, once, on the collection's channel: a 16-byte
coin flip (the XOR of both sides' halves is its sketch seed; sent in every
mode, because a JAX peer sends it), then in secure mode the two base-OT
sessions, one per garbling direction.  Per level, trusted: the packed share bits are swapped
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

Malicious mode (``protocol/sketch.py``): ``add_keys`` carries each chunk's
sketch keys, ``tree_init`` commits the challenge ratchet's root (the
plane's coin flip), every prune advances the frontier-following sketch
states and absorbs its survivor table into the transcript digest, and
``sketch_verify`` runs the sketch and Beaver checks over the data plane
(two swaps a checked depth) and ANDs the verdicts into the client
liveness that gates every count; checkpoints carry the sketch state.

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

Data shards (``Config.server_data_devices``, the binary's
``FHH_DATA_DEVICES``; ``parallel/server_mesh.py``): a server with k > 1
shards splits its key batch, frontier and child cache along the client
axis, N/k clients a shard, and expands each shard through the expand
kernel on its own slice.  The trusted count is taken per shard and summed
before the wire; the secure kernel stage runs row-sharded, its field share
sums folded over shards (``parallel/kernel_shard.py``,
``Config.secure_kernel_shards``; a level that fills one planar block
gathers its share bits onto the first shard instead and runs the
whole-level path there, counted in ``kernel_gathers``) and the sketch check per
client slice (``parallel/sketch_shard.py``, ``Config.sketch_shards``).
Every wire frame is the unsharded server's byte for byte, so neither the
peer nor the leader can tell.  A device fault (``MeshChaos`` at a crawl
verb's entry, the binary's ``FHH_MESH_FAULTS``) re-shards inside the verb
from the checkpoint of the level before and re-runs it; with no such
checkpoint the server breaks its data plane and answers the error, and
the supervising leader's recovery takes over.  ``status`` reports the
shards in its ``mesh`` section.

Streaming ingestion (JAX rpc.py:1442-1660): ``submit_keys`` lands a
submission in a tumbling window's pool through the admission gate of
``resilience/admission.py`` (token bucket, quotas, reject or seeded
reservoir shedding; server 0 decides, server 1 applies its verdict as
``mirror``), outside the verb lock, idempotent per ``sub_id``;
``window_seal`` freezes a window (in malicious mode committing
``sketch.window_root`` as its challenge root); ``window_load`` makes a
sealed pool the next crawl's key batch.  The pools live in the
collection's session, ride every checkpoint as the JAX blob's ``ing_*``
fields, and an ``ingest_only`` blob banks them between windows.

Collections (JAX rpc.py:63-84): everything above that one collection owns
lives in its ``sessions.CollectionSession``, selected by the ``collection``
field of ``__hello__``; one server pair crawls many collections at once,
each with its own keys, frontier, OT sessions, sketch, ingest gate, replay
and checkpoint namespaces and verb lock.  Device stages take FIFO turns
across collections (``tenancy.TenantScheduler``), so one collection's
expand fills the gap another's wire wait leaves (a stall fill), and the
warmup's ladder of warmed shapes is shared by the process.  A connection
that names no collection works on the default one, so every single-tenant
flow, checkpoint names included, is unchanged.

Fleet migration (JAX rpc.py:1662-1890; ``protocol/fleet.py``):
``session_export`` banks a collection's ingest state as a blob stamped
with the server's boot id and the collection's export epoch, and its
retire mode drops the source copy once the destination holds it;
``session_import`` adopts such a blob (or the collection's own ingest
checkpoint, after its pair died), checking everything before it changes
anything, and forces the collection's channel to key up again against
this pair's peer.  The blob is the JAX server's field for field, so
either package imports the other's export.

Telemetry (JAX rpc.py:644-1054, ``obs/``): each server owns a registry
``server{id}`` (shared with its default collection; every other
collection has ``server{id}:{key}``), and records the JAX server's
counters, gauges, phase spans (``fss``, ``gc_ot``, ``field``, the secure
steps, ``sketch``, ``ici_reduce``, ``plane_handshake``, ``warmup``, a
``verb:{verb}`` span a verb) and histograms (``level_latency``,
``rpc:{verb}``, ``seal_to_hitters``) under the same names and levels.  A
request's ``trace`` field activates the leader's trace context around the
verb; ``FHH_PROFILE_LEVELS`` wraps the named levels' device work in a
``torch.profiler`` capture; ``status`` samples device memory and carries
the ``slo`` section.  ``server.exit``'s flat counters are read from the
registries (:meth:`CollectorServer.summary`).
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import os
import pickle
import secrets
import socket
import struct
import time
import weakref

import numpy as np
import torch

from .. import obs
from ..obs import alerts as obsalerts
from ..obs import devmem as obsdevmem
from ..obs import exporter as obsexporter
from ..obs import metrics as obsmetrics
from ..obs import trace as obstrace
from ..ops import baseot, dpf, ibdcf, otext
from ..ops.fields import F255, FE62
from ..parallel import kernel_shard, sketch_shard
from ..parallel import server_mesh as smesh
from ..parallel.server_mesh import Sharded
from ..resilience import chaos as reschaos
from ..resilience import policy as respolicy
from ..ops.ibdcf import EvalState
from ..utils import guards, taint_guard
from ..utils import resolve_device, tensor_from_numpy, words_from_numpy, words_to_numpy
from ..utils.config import Config
from . import collect, mpc, secure, sessions, tenancy
from . import sketch as sketchmod
from .driver import PhaseClock
from .sessions import DEFAULT_COLLECTION

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


def _readonly(obj):
    """Numpy arrays in ``obj`` as read-only views, which pickle as bytes, as
    the arrays a JAX server reads back from its device do (a writable
    array pickles as a bytearray, a few bytes longer): the data-plane
    frames and the secure share answers are then the JAX server's byte for
    byte."""
    if isinstance(obj, np.ndarray):
        if obj.flags.writeable:
            obj = obj.view()
            obj.flags.writeable = False
        return obj
    if isinstance(obj, dict):
        return {k: _readonly(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_readonly(v) for v in obj]
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return tuple(_readonly(v) for v in obj)
    return obj


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
    # fhh-lint: disable=unbounded-await (see docstring)
    (n,) = _HDR.unpack(await reader.readexactly(_HDR.size))
    if count is not None:
        count(n + _HDR.size)
    # fhh-lint: disable=unbounded-await (see docstring)
    return pickle.loads(await reader.readexactly(n))


async def _fetch_words(t: torch.Tensor) -> np.ndarray:
    """int32 device words -> uint32 host array, off the event loop (two
    servers in one loop must not serialize on a device->host copy)."""
    return await asyncio.to_thread(words_to_numpy, t)


def _share_wire(field, sh: torch.Tensor) -> np.ndarray:
    """Share sums in the JAX package's wire dtype: FE62 uint64 bit
    patterns, F255 uint32[..., 8] limbs."""
    if field is F255:
        return _readonly(words_to_numpy(sh))
    return _readonly(sh.detach().cpu().numpy().view(np.uint64))


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


# replay-dedup bounds (the JAX package's): the cache must cover every request
# a client could still replay — its in-flight window (the key upload's 256)
# and slack — and is bounded by bytes too, since crawl answers are share
# arrays; sessions are bounded so that reconnecting leaders cannot grow it
_SESSION_CACHE_CAP = 1024
_SESSION_CACHE_BYTES = 128 << 20
_SESSION_CAP = 8

# a closed control connection's drain (the JAX server's): its verb tasks are
# polled this often, and cancelled once none has finished for the backstop
DRAIN_POLL_S = 30.0
DRAIN_BACKSTOP_S = 1800.0


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
    (``cache``) and verbs still running (``inflight``), and the collection
    its last ``__hello__`` bound."""

    __slots__ = ("cache", "sizes", "bytes_total", "inflight", "last_seen", "collection")

    def __init__(self):
        self.collection = DEFAULT_COLLECTION
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


# The lock-discipline sanitizer's map of the server's own state (JAX
# rpc.py:266-270; a collection's state is sessions._SESSION_GUARDS'): the
# leader sessions' replay table belongs to the server's lock.
_SERVER_GUARDS = {
    "_sessions": "_verb_lock",
}


def _session_metrics_producer(ref):
    """A /metrics producer bound to a server by weakref (JAX rpc.py:273-320):
    at each scrape, the live collections' rows as labelled gauges, and the
    session alert rules over the same rows.  ``None`` once the server is
    gone, so the exporter prunes it.  It runs in the scrape thread, where
    :meth:`CollectorServer.sessions_status` opens its own unguarded window."""

    def produce():
        srv = ref()
        if srv is None:
            return None
        try:
            sess = srv.sessions_status()
        # fhh-lint: disable=broad-except (scrape-thread probe racing the
        # event loop: a torn dict iteration skips one frame, never 500s)
        except Exception:
            return []
        obsalerts.evaluate_sessions(sess["per_session"], source=f"server{srv.server_id}")
        reg = f'registry="server{srv.server_id}"'
        lines = ["# TYPE fhh_session_last_progress_seconds gauge",
                 "# TYPE fhh_session_queue_depth_keys gauge",
                 "# TYPE fhh_session_dedup_entries gauge"]
        for key, row in sorted(sess["per_session"].items()):
            lbl = f'{{{reg},collection="{obsexporter._esc(key)}"}}'
            lines.append(f"fhh_session_last_progress_seconds{lbl} {row['last_progress_s']}")
            lines.append(f"fhh_session_queue_depth_keys{lbl} {row['queue_depth']}")
            lines.append(f"fhh_session_dedup_entries{lbl} {row['dedup_entries']}")
        return lines

    return produce


def _load_npz(path: str) -> dict:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


class CollectorServer:
    """One collector server (ref: server.rs:44-172) holding one party's key
    shares, its own OT secrets and its own crawl state on ``device``; only
    wire frames cross to the peer.  ``server_id`` 0 dials the peer, 1
    listens.  ``ckpt_dir`` (the binary's ``FHH_CKPT_DIR``) holds the
    checkpoint blobs; without it ``tree_checkpoint`` and ``tree_restore``
    refuse.  ``emit(event, **fields)`` receives the recovery events
    (``resilience.server_checkpoint``, ``resilience.server_restore``,
    ``resilience.plane_reset``, ``resilience.plane_break``,
    ``resilience.mesh_reshard``, ``warmup.shard_mismatch``).  Data shards
    come from ``cfg.server_data_devices`` (``parallel/server_mesh.py``);
    ``mesh_chaos`` (a ``resilience.chaos.MeshChaos``) injects device faults
    at a crawl verb's entry, into whichever collection reaches its level
    first.  With the exporter running, the server publishes its session rows
    at each scrape (:func:`_session_metrics_producer`); under
    ``FHH_DEBUG_GUARDS=1`` or ``cfg.debug_guards`` the lock-discipline
    sanitizer guards its replay table (:data:`_SERVER_GUARDS`) and each
    collection's state.

    The server holds only what its collections share: the listeners, the
    data plane (:class:`sessions.PlaneMux`), the replay caches, the tenant
    scheduler, the boot id and its registry ``obs`` (``server{id}``, also
    the default collection's; the shared plane's figures live there).
    Everything one collection owns lives in its
    :class:`sessions.CollectionSession` (``_table``), resolved per
    connection from ``__hello__``; the attributes below the constructor
    read and write the default collection's, so single-tenant callers see
    the server they knew."""

    VERBS = ("reset", "add_keys", "tree_init", "tree_crawl", "tree_crawl_last",
             "tree_prune", "tree_prune_last", "final_shares", "warmup", "status",
             "tree_checkpoint", "tree_restore", "plane_reset", "plane_break", "sketch_verify",
             "submit_keys", "window_seal", "window_load", "session_export", "session_import")

    def __init__(self, server_id: int, cfg: Config, device=None, *, ckpt_dir=None,
                 emit=None, mesh_chaos=None):
        if server_id not in (0, 1):
            raise ValueError(f"server_id must be 0 or 1, got {server_id}")
        self.server_id = server_id
        self.cfg = cfg
        self.device = resolve_device(device)
        self._mesh_chaos = mesh_chaos
        self.boot_id = secrets.token_hex(8)
        self.ckpt_dir = ckpt_dir
        self.emit = emit or obs.emit
        # one registry for the server's shared plane (control bytes, replay
        # dedup, plane resets, the scheduler), which the default collection
        # shares (JAX rpc.py:338-347)
        self.obs = obsmetrics.Registry(f"server{server_id}")
        self._table = sessions.SessionTable(server_id, cfg, self.device, ckpt_dir, self.obs)
        self._sched = tenancy.TenantScheduler(self.obs)
        self._plane = sessions.PlaneMux(route_count=self._plane_count, tag=f"server{server_id}")
        # serializes plane_reset: the plane is shared by every collection,
        # whose own verbs serialize on their session's lock
        self._verb_lock = asyncio.Lock()
        self._sessions: dict = {}  # leader session id -> _Session
        self._peer_addr = None  # server 0: where it dials the plane
        self._peer_reader = self._peer_writer = None
        self._rpc_srv = self._peer_srv = None
        self._ctl_writers: set = set()
        # the live plane: by weakref, so a dropped server's producer is
        # pruned rather than pinning its registries
        if obsexporter.running():
            obsexporter.add_producer(_session_metrics_producer(weakref.ref(self)))
        # last: the sanitizer wraps the state already built (a no-op unless
        # FHH_DEBUG_GUARDS=1 or cfg.debug_guards)
        guards.install(self, _SERVER_GUARDS, force=cfg.debug_guards)

    # -- the default collection's state, for single-tenant callers ------------

    def _default(self) -> sessions.CollectionSession:
        return self._table.default()

    def _state_prop(name):  # noqa: N805 (class-body helper, deleted below)
        return property(lambda self: getattr(self._default(), name),
                        lambda self, value: setattr(self._default(), name, value))

    keys = _state_prop("keys")
    keys_parts = _state_prop("keys_parts")
    alive_keys = _state_prop("alive_keys")
    frontier = _state_prop("frontier")
    children = _state_prop("children")
    last_shares = _state_prop("last_shares")
    _mesh = _state_prop("_mesh")
    _sketch_parts = _state_prop("_sketch_parts")
    _sketch = _state_prop("_sketch")
    _sketch_states = _state_prop("_sketch_states")
    _sketch_pids = _state_prop("_sketch_pids")
    _sketch_depth = _state_prop("_sketch_depth")
    _sketch_pairs = _state_prop("_sketch_pairs")
    _sketch_seed = _state_prop("_sketch_seed")
    _sketch_root = _state_prop("_sketch_root")
    _ratchet_digest = _state_prop("_ratchet_digest")
    _ot_snd = _state_prop("_ot_snd")
    _ot_rcv = _state_prop("_ot_rcv")
    _sec_seed = _state_prop("_sec_seed")
    del _state_prop

    @property
    def _ingest(self) -> sessions.CollectionSession:
        """The default collection's ingest pools and gate."""
        return self._default()

    @property
    def _plane_keyed(self) -> bool:
        """The default collection's channel is keyed on the current plane."""
        return self._keyed(self._default())

    @_plane_keyed.setter
    def _plane_keyed(self, value: bool) -> None:
        self._default().plane_epoch = self._plane.epoch if value else -1

    def _keys_fp(self) -> np.ndarray:
        return self._default()._keys_fp()

    def crawl_radix(self, level: int) -> int:
        return self._default().crawl_radix(level)

    def mesh_status(self) -> dict | None:
        return self._default().mesh_status()

    def _ckpt_path(self, level: int) -> str:
        return self._default().ckpt_path(level)

    def _ckpt_levels(self) -> list:
        return self._default().ckpt_levels()

    def _ckpt_prune(self, keep: int = 2) -> None:
        self._default().ckpt_prune(keep)

    # -- telemetry ----------------------------------------------------------------

    def _plane_count(self, chan: str, nbytes: int) -> None:
        """The mux's accounting hook: a received frame's bytes go to its
        collection's registry, whose active span gives them their level (a
        channel with no session here: the server's)."""
        cs = self._table.peek(chan)
        (cs.obs if cs is not None else self.obs).count("data_bytes_recv", nbytes)
        self._note_frame(nbytes)

    def _note_frame(self, nbytes: int) -> None:
        """The largest data-plane frame either way (a port-only gauge)."""
        if nbytes > (self.obs.gauge_value("data_frame_max") or 0):
            self.obs.gauge("data_frame_max", nbytes)

    def _registries(self) -> list:
        """The server's registry and every other live collection's."""
        return [self.obs] + [cs.obs for _, cs in self._table.items()
                             if cs.obs is not self.obs]

    def summary(self) -> dict:
        """``server.exit``'s flat figures, read from the registries: the
        collections' counters summed (:func:`sessions.summary`), then the
        shared plane's control bytes, replays answered from the cache, plane
        resets and largest data-plane frame."""
        out = sessions.summary([r.report() for r in self._registries()])
        for name in ("control_bytes_sent", "control_bytes_recv", "dedup_hits", "plane_resets"):
            out[name] = int(self.obs.counter_value(name))
        out["data_frame_max"] = int(self.obs.gauge_value("data_frame_max") or 0)
        return out

    # -- verbs ----------------------------------------------------------------
    # Each takes the collection bound by its connection's hello (``cs``; the
    # default one when called directly) and runs under that session's lock.

    async def reset(self, _req, cs=None) -> bool:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        cs = cs or self._default()
        # the default collection's registry is the server's: with other
        # collections live its reset keeps their shared-plane figures
        cs.reset_state(reset_obs=(cs.key != DEFAULT_COLLECTION or len(self._table) <= 1))
        return True

    async def add_keys(self, req, cs=None) -> bool:  # fhh-race: atomic (unlocked upload fast path: append-only, never suspends — many in-flight batches deserialize concurrently by design)
        """Append one key chunk: the five leaves of a [B, d, 2] batch, and in
        malicious mode the 16 leaves of the same clients' sketch keys
        (``sketch``, :func:`sketch.sketch_leaves` order)."""
        cs = cs or self._default()
        sk = req.get("sketch")
        if sk is not None and len(sk) != 16:
            raise ValueError(f"add_keys: a sketch chunk has 16 leaves, got {len(sk)}")
        cs.obs.count("add_keys")
        # fhh-lint: disable=chunked-device-readback (wire input: pickled host numpy, no device involved)
        cs.keys_parts.append(tuple(np.asarray(a) for a in req["keys"]))
        cs._keys_stale = True
        if sk is not None:
            # fhh-lint: disable=chunked-device-readback (wire input: pickled host numpy, no device involved)
            cs._sketch_parts.append(tuple(np.asarray(a) for a in sk))
        return True

    async def tree_init(self, req, cs=None) -> bool:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        cs = cs or self._default()
        if not cs.keys_parts and cs.keys is None:
            raise RuntimeError("tree_init before add_keys")
        await self._ensure_session_plane(cs)
        cs._concat_keys("tree_init")
        cs.alive_keys = torch.ones(cs._n_clients(), dtype=torch.bool, device=self.device)
        rb = int((req or {}).get("root_bucket", 1))
        cs.frontier = cs._one([collect.tree_init(k, rb) for k in cs._shards(cs.keys)])
        cs.children = cs.last_shares = None
        cs.clear_spans()
        if cs._has_sketch():
            cs._concat_sketch()
            root = dpf.eval_init(cs._sketch.key)  # [N, d]
            cs._sketch_states = dpf.DpfEvalState(seed=root.seed[None], t=root.t[None])
            cs._sketch_pids = np.zeros((1, root.t.shape[1]), np.int32)
            cs._sketch_depth = 0
            cs._sketch_pairs = None
            # commit the ratchet: the root is this channel's coin flip (the
            # clients committed their keys before it), the transcript empty;
            # both are checkpointed, so later plane resets and restarts
            # cannot move any level's challenge.  A loaded window commits
            # its seal-time root instead (sketch.window_root), which its seal
            # stats and ingest checkpoint carry: a recovered window's re-run
            # replays the same challenges
            root = (cs._window_sketch_root if cs._window_sketch_root is not None
                    else cs._sketch_seed)
            cs._sketch_root = np.asarray(root, np.uint32).copy()
            cs._ratchet_digest = sketchmod.transcript_init()
        return True

    def _advance_and_absorb(self, cs, level: int, parent, pat, n_alive: int) -> None:
        """A prune's sketch half: advance the states, then fold the survivor
        table into the transcript digest."""
        t0 = time.perf_counter()
        cs.advance_sketch(level, parent, pat, n_alive)
        cs._ratchet_digest = sketchmod.transcript_absorb(cs._ratchet_digest, level, parent,
                                                         pat, n_alive)
        cs.obs.timer_add("sketch_advance", time.perf_counter() - t0, level=level)

    async def sketch_verify(self, req, cs=None) -> np.ndarray:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """The malicious-security check (JAX rpc.py:541-696): sketch inner
        products and Beaver verification over the data plane, per (client,
        dim); a client fails if any dim fails, and its liveness flag flips
        before the gated counts are taken.  ``level`` 0 verifies the full
        depth-1 level (both children of every dim's root) and must come
        before any prune; ``level`` >= 2 verifies each depth the last prune
        stored, under its own ratcheted challenge and its own Beaver slab,
        with two swaps a depth (the cor stack, then the out shares).  Level
        1 is refused: the level-0 check consumed depth 1's triples, and a
        second opening under another challenge would leak ``<r - r', x>``;
        so is every level past 0 when data_len is 1.  -> a copy of the
        client liveness vector, bool[N]."""
        cs = cs or self._default()
        if cs._sketch is None:
            raise RuntimeError("sketch_verify without sketch keys")
        await self._ensure_session_plane(cs)
        level = int(req["level"])
        with cs.obs.span("sketch", level=level):
            out = await self._sketch_checks(cs, level)
        cs.obs.count("sketch_verifies")
        return out

    async def _sketch_checks(self, cs, level: int) -> np.ndarray:
        k = cs._sketch.key
        L = k.data_len
        n, d = k.root_seed.shape[0], k.root_seed.shape[1]
        if level == 0:
            if cs._sketch_depth != 0:
                raise RuntimeError("level-0 full check called after the tree advanced")
            last = L == 1
            fld = F255 if last else FE62
            st = dpf.DpfEvalState(seed=cs._sketch_states.seed[0], t=cs._sketch_states.t[0])
            cw = dpf.level_cw(k, 0)
            cwv = k.cw_val[..., 0, :] if not last else k.cw_val_last
            sides = [dpf.eval_bit(cw, st, torch.full((n, d), c, device=self.device), cwv,
                                  k.key_idx, fld, sketchmod.LANES)[1] for c in (False, True)]
            checks = [(torch.stack(sides), 0, fld, 0)]  # [2, N, d, LANES(, limbs)]
        else:
            if L == 1:
                raise RuntimeError("data_len=1: the leaf check is the level-0 full check")
            if level == 1:
                raise RuntimeError("depth 1 is covered by the level-0 full check; "
                                   "re-verifying it would re-open its Beaver triples")
            if cs._sketch_pairs is None or cs._sketch_pairs[-1][1] != level:
                raise RuntimeError(f"no stored sketch shares for depth {level}")
            # one stored entry per fused bit level, depth 1 dropped (the
            # level-0 check opened its slab)
            checks = [(p, dep - 1, f, dep) for (p, dep, f) in cs._sketch_pairs if dep >= 2]
        sk = cs._sketch
        # with data shards the check batch splits along its clients
        # (parallel/sketch_shard.py): the same wire, assembled by position
        ss = cs._sketch_bind(n, d)
        cs.obs.gauge("sketch_shards", 1 if ss is None else ss.k, level=level)
        fetches = 1 if ss is None else ss.k
        ok_all = None
        for pairs, dpf_level, fld, depth in checks:
            if fld is F255:
                trip, mk, mk2 = sk.triples_last, sk.mac_key_last, sk.mac_key2_last
            else:
                trip, mk, mk2 = mpc.level_slab(sk.triples, dpf_level), sk.mac_key, sk.mac_key2
            cor, state = sketch_shard.cor_state(ss, fld, pairs, trip, mk, mk2,
                                                cs.challenge_seed(depth), depth)
            peer_cor = await self._swap(cs, await asyncio.to_thread(sketch_shard.wire, cor))
            o = sketch_shard.out_shares(ss, fld, state, cor, peer_cor, bool(self.server_id))
            del state, cor
            peer_o = await self._swap(cs, await asyncio.to_thread(sketch_shard.wire, o))
            ok = sketch_shard.verdicts(ss, fld, o, peer_o)
            cs.obs.count("device_fetches", 2 * fetches, level=level)
            ok_all = ok if ok_all is None else ok_all & ok
        if ok_all is not None:
            cs.alive_keys &= ok_all
        if level != 0:
            # each stored depth opens once; a re-run after a recovery reloads
            # the pairs from the checkpoint and replays the same challenge
            cs._sketch_pairs = None
        cs.obs.count("device_fetches", level=level)  # the verdicts' readback
        # fhh-lint: disable=host-sync-in-hot-loop (the verdicts' one readback a sketch check, off the event loop and counted above)
        return await asyncio.to_thread(lambda: cs.alive_keys.cpu().numpy().copy())

    async def tree_crawl(self, req, cs=None) -> np.ndarray:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """-> FE62 shares uint64[F, 2^d] of the per-child counts (rpc.rs:60)."""
        return await self._crawl(cs or self._default(), "tree_crawl", req, last=False)

    async def tree_crawl_last(self, req, cs=None) -> np.ndarray:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """-> F255 shares uint32[F, 2^d, 8] of the last level (rpc.rs:61),
        kept for ``tree_prune_last`` and ``final_shares``; a span's shares
        are banked for ``tree_prune_last`` to assemble."""
        cs = cs or self._default()
        shares = await self._crawl(cs, "tree_crawl_last", req, last=True)
        shard = self._parse_shard(req)
        if shard is None:
            cs.last_shares = shares
        else:
            cs.last_shares = None
            cs._shard_last[shard[0]] = shares
        return shares

    async def tree_prune(self, req, cs=None) -> bool:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Fused prune + advance: the surviving children, gathered from this
        round's child cache (ref: rpc.rs:63, collect.rs:918-929), assembled
        from its spans when the round was crawled in spans.  A prune with no
        cache re-expands the round's r bits first."""
        cs = cs or self._default()
        if cs.frontier is None:
            raise RuntimeError("tree_prune before tree_init")
        level = int(req["level"])
        parent, pat, n_alive = self._prune_args(req)
        r = pat.shape[1]
        if r != cs.crawl_radix(level):
            raise RuntimeError(
                f"prune pattern carries {r} step bit(s) where this session's level-{level} "
                f"round fuses {cs.crawl_radix(level)} (crawl_radix_bits mismatch between "
                "leader and server?)")
        cs._expand_ready.clear()  # the frontier is about to change
        if cs.children is None and cs._shard_children:
            cs.children = cs._assemble_shard_children(r)
        children = cs.children
        if children is None:
            children = cs._one([
                collect.expand_share_bits_radix(k, f, level, r, want_children=True)[1]
                for k, f in zip(cs._shards(cs.keys), cs._shards(cs.frontier))])
        par, pt = torch.from_numpy(parent), torch.from_numpy(pat)
        cs.frontier = cs._one([
            collect.advance_from_children_radix(c, par.to(c.seed.device), pt.to(c.seed.device),
                                                n_alive, r)
            for c in cs._shards(children)])
        cs.children = None
        if cs._sketch is not None:  # the sketch states follow the same survivors
            self._advance_and_absorb(cs, level, parent, pat, n_alive)
        cs.obs.gauge("survivors", n_alive, level=level)
        return True

    async def tree_prune_last(self, req, cs=None) -> bool:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Compact the last level's shares to the survivors
        (ref: collect.rs:931-942)."""
        cs = cs or self._default()
        cs._expand_ready.clear()
        if cs.last_shares is None and cs._shard_last:
            whole = np.concatenate([p for _, p in sorted(cs._shard_last.items())], axis=0)
            if whole.shape[0] != cs._f_bucket():
                raise RuntimeError(f"sharded last crawl incomplete: shares cover "
                                   f"{whole.shape[0]} of {cs._f_bucket()} slots")
            cs.last_shares = whole
            cs._shard_last.clear()
        if cs.last_shares is None:
            raise RuntimeError("tree_prune_last called before tree_crawl_last")
        cs.children = None
        parent, pat, n_alive = self._prune_args(req)
        _, r, d = pat.shape
        base = cs._data_len() - r
        if r != cs.crawl_radix(base):
            raise RuntimeError(f"leaf prune pattern carries {r} step bit(s) where this "
                               f"session's tail round fuses {cs.crawl_radix(base)}")
        # the step-major fused leaf id
        shift = np.arange(r)[:, None] * d + np.arange(d)[None, :]
        child = (pat[:n_alive].astype(np.int64) << shift).sum(axis=(1, 2))
        cs.last_shares = cs.last_shares[parent[:n_alive], child]
        if cs._sketch is not None:  # once more, for the F255 leaf payloads
            self._advance_and_absorb(cs, base, parent, pat, n_alive)
        cs.obs.gauge("survivors", n_alive, level=cs._data_len() - 1)
        return True

    async def final_shares(self, _req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """The surviving leaves' count shares (ref: rpc.rs:65).  After a
        loaded window's crawl, the seconds since that window's seal go to
        the ``seal_to_hitters`` histogram, once a window."""
        cs = cs or self._default()
        if cs._window_seal_ts is not None:
            cs.obs.observe("seal_to_hitters", max(0.0, time.time() - cs._window_seal_ts))
            cs._window_seal_ts = None
        return {"server_id": self.server_id, "shares": cs.last_shares}

    # -- the streaming ingest front door (JAX rpc.py:1442-1660): the online
    # successor of the one-shot add_keys upload --------------------------------

    async def submit_keys(self, req, cs=None) -> dict:
        """One submission into the named window's pool: admission-controlled,
        append-only, idempotent per ``sub_id``.  Runs without the verb lock
        (as ``add_keys``), so a window fills while the previous one's crawl
        holds it; the admission arithmetic runs in an executor behind the
        collection's own gate (a flooding tenant drains only its own token
        bucket), and after that one suspension the duplicate and seal checks
        run again before the pool changes.

        Req: ``{window, sub_id, client_id, keys}``, in malicious mode
        ``sketch`` (the same clients' 16 sketch leaves, :func:`sketch.
        sketch_leaves` order, riding the entry tuple), and ``mirror`` (the
        gate server's verdict, which server 1 applies positionally, so the
        two pools stay identical).  Answers ``{"admitted": True, "slot"}``,
        ``{"admitted": False, "shed": True}`` (reservoir mode: final), or
        ``{"admitted": False, "overloaded": True, "scope", "retry_after_s"}``
        (retryable); a replayed ``sub_id`` answers its recorded verdict with
        ``dup`` True."""
        cs = cs or self._default()
        window = int(req["window"])
        sub_id = str(req["sub_id"])
        # fhh-lint: disable=chunked-device-readback (wire input: pickled host numpy, no device involved)
        chunk = tuple(np.asarray(a) for a in req["keys"])
        n_keys = int(chunk[0].shape[0])
        sk = req.get("sketch")
        if sk is not None:
            if not self.cfg.malicious:
                raise RuntimeError("sketch material submitted to a semi-honest collector "
                                   "(cfg.malicious is off)")
            if len(sk) != 16:
                raise ValueError(f"submit_keys: a sketch chunk has 16 leaves, got {len(sk)}")
            # fhh-lint: disable=chunked-device-readback (wire input: pickled host numpy, no device involved)
            chunk = chunk + tuple(np.asarray(a) for a in sk)
        elif self.cfg.malicious:
            raise RuntimeError("malicious mode: submit_keys requires the client's sketch "
                               "chunk alongside its keys")
        pool = cs.ingest_pool(window)
        cs.obs.count("pool_submits")
        prev = pool.verdicts.get(sub_id)
        if prev is not None:  # a replay: the recorded verdict, nothing re-admitted
            cs.obs.count("pool_dup_submits")
            return dict(prev, dup=True)
        if pool.sealed:
            raise RuntimeError(f"ingest window {window} is sealed — submit into a later window")
        mirror = req.get("mirror")
        if mirror is not None:  # never suspends: applied positionally
            resp = pool.apply_mirror(sub_id, chunk, mirror, str(req.get("client_id", "")))
        else:
            v = await cs._admission.admit_offloaded(pool.wa, str(req.get("client_id", "")),
                                                    n_keys, gate=cs._adm_gate)
            # another frame may have replayed this sub_id or sealed the
            # window during the await
            prev = pool.verdicts.get(sub_id)
            if prev is not None:
                cs.obs.count("pool_dup_submits")
                return dict(prev, dup=True)
            if pool.sealed:
                raise RuntimeError(f"ingest window {window} sealed during admission — "
                                   "submit into a later window")
            resp = pool.apply(sub_id, chunk, v)
        if resp.get("admitted"):
            cs.obs.count("pool_admitted_keys", n_keys)
        elif resp.get("shed"):
            cs.obs.count("pool_shed_keys", n_keys)
        else:
            cs.obs.count("pool_rejected")
        return resp

    async def window_seal(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Freeze the named window: later submissions name later windows.
        Idempotent: sealing a sealed window returns the same stats.  In
        malicious mode the first seal commits the window's challenge root,
        ``sketch.window_root`` of this channel's coin flip and the window; a
        recovery re-seal hands back the root banked at the first seal
        (``sk_root``), which a pool rebuilt from the journal takes and a
        pool holding another refuses.  -> the pool's stats."""
        cs = cs or self._default()
        w = int(req["window"])
        pool = cs._ingest_pools.get(w)
        if pool is None:
            pool = cs.ingest_pool(w)  # sealing an idle window is legal
        want_root = req.get("sk_root")
        if want_root is not None:
            want_root = np.array(want_root, np.uint32)
            if pool.sk_root is None:
                pool.sk_root = want_root
            elif not np.array_equal(pool.sk_root, want_root):
                raise RuntimeError(f"window_seal: window {w} already committed a different "
                                   "sketch root (recovery replayed stats from another life?)")
        if not pool.sealed:
            if self.cfg.malicious and pool.sk_root is None:
                await self._ensure_session_plane(cs)
                pool.sk_root = sketchmod.window_root(cs._sketch_seed, w)
            pool.sealed = True
            pool.sealed_at = time.time()
            cs.obs.count("windows_sealed")
            self.emit("ingest.window_sealed", server=self.server_id,
                      collection=cs.key, window=w, keys=pool.keys,
                      subs=len(pool.entries), shed=pool.shed_keys,
                      sk_root=None if pool.sk_root is None else pool.sk_root.tolist())
        return pool.stats()

    async def window_load(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Make a sealed window's frozen pool the crawl's key batch (the
        streaming twin of the ``add_keys`` upload): the crawl and sketch
        state clear, the pool's entries become the uploaded chunks in slot
        order (with data shards they are placed per shard at ``tree_init``
        and kept for a re-shard, as an upload's), the sketch leaves split
        back into sketch chunks, the window's root is installed for
        ``tree_init``, and earlier windows' pools are dropped.  Every
        refusal comes before any state changes."""
        cs = cs or self._default()
        w = int(req["window"])
        pool = cs._ingest_pools.get(w)
        if pool is None:
            raise RuntimeError(f"window_load: no ingest pool for window {w}")
        if not pool.sealed:
            raise RuntimeError(f"window_load: window {w} is not sealed")
        if not pool.entries:
            raise RuntimeError(f"window_load: window {w} admitted no keys")
        nk = len(ibdcf.IbDcfKeyBatch._fields)
        has_sketch = len(pool.entries[0]) > nk
        if self.cfg.malicious and not has_sketch:
            raise RuntimeError(f"window_load: malicious mode but window {w} carries no "
                               "sketch material (submitted before cfg.malicious?)")
        if has_sketch and pool.sk_root is None:
            raise RuntimeError(f"window_load: window {w} carries sketch material but no "
                               "committed challenge root (sealed by a pre-sketch server?)")
        cs.clear()
        cs.keys_parts = [tuple(e[:nk]) for e in pool.entries]
        cs._keys_stale = True
        if has_sketch:
            cs._sketch_parts = [tuple(e[nk:]) for e in pool.entries]
            cs._window_sketch_root = np.array(pool.sk_root, np.uint32)
        cs._window_seal_ts = pool.sealed_at
        for old in [k for k in cs._ingest_pools if k < w]:
            del cs._ingest_pools[old]
        self.emit("ingest.window_loaded", server=self.server_id,
                  collection=cs.key, window=w, keys=pool.keys, sketch=has_sketch)
        return {"window": w, "keys": pool.keys, "subs": len(pool.entries),
                "sketch": has_sketch}

    # -- fleet migration (JAX rpc.py:1662-1890; protocol/fleet.py) --------------

    async def session_export(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Bank the collection's migratable state as a stamped blob for a
        ``session_import`` on another pair, or, in retire mode, drop the
        source copy after the destination confirmed its import.

        An export happens at a window or level boundary only: a collection
        holding a level's child cache or spans refuses (a torn level would
        leave half an exchange on each pair).  The blob is the ingest form
        of the checkpoint (pools, recorded verdicts, quota ledgers, the
        reservoir's state, each sealed window's challenge root), stamped
        with the collection, the crawl radix, this server's boot id and the
        collection's export epoch.  Crawl state stays behind: a windowed
        crawl rebuilds it from the pools, and the destination keys its own
        channel, while the windows' roots ride the pools, so a migrated
        malicious window replays the identical challenge.

        Retire (``{"retire": True, "epoch": E}``, E the last export's epoch):
        every pool (sealed ones too), the crawl state and keys and the export
        file go, and the scheduler forgets the collection, whose idle
        session the table may then evict."""
        cs = cs or self._default()
        req = req or {}
        if req.get("retire"):
            epoch = int(req.get("epoch", -1))
            if epoch <= 0 or epoch != cs._export_epoch:
                raise RuntimeError(f"session_export: retire epoch {epoch} does not match the "
                                   f"last export ({cs._export_epoch}) — refusing to drop state "
                                   "that was never transferred")
            dropped = len(cs._ingest_pools)
            cs._ingest_pools.clear()
            cs.clear()
            if cs.ckpt_dir is not None and os.path.exists(self._export_path(cs)):
                os.remove(self._export_path(cs))
            # a migrated-away collection must not hold this pair's
            # progress-age signal high for ever
            self._sched.forget(cs.key)
            cs.obs.count("sessions_retired")
            self.emit("fleet.session_retired", server=self.server_id, collection=cs.key,
                      pools_dropped=dropped)
            return {"retired": True, "pools_dropped": dropped}
        # mid-level: a child cache between crawl and prune, or spans being
        # assembled; the last shares alone linger after a finished crawl
        if cs.children is not None or cs._shard_children or cs._shard_last:
            raise RuntimeError("session_export: session is mid-level — a migration quiesces "
                               "at a window/level boundary only")
        if cs.ckpt_dir is None:
            raise RuntimeError("session_export: no checkpoint dir configured (start the "
                               "server with FHH_CKPT_DIR set)")
        blob = {"ing_only": np.bool_(True), "sess": np.str_(cs.key), "level": np.int64(-1),
                "radix": np.int64(self.cfg.crawl_radix_bits)}
        cs.ingest_ckpt_fields(blob)
        cs._export_epoch += 1
        blob["xp_boot"] = np.str_(self.boot_id)
        blob["xp_epoch"] = np.int64(cs._export_epoch)
        path = self._export_path(cs)
        tmp = f"{path}.tmp{os.getpid()}"

        def write():
            with open(tmp, "wb") as f:
                np.savez(f, **blob)
            os.replace(tmp, path)

        await asyncio.to_thread(write)
        cs.obs.count("session_exports")
        windows = sorted(cs._ingest_pools)
        self.emit("fleet.session_exported", server=self.server_id, collection=cs.key,
                  epoch=cs._export_epoch, windows=windows, path=path,
                  bytes=os.path.getsize(path))
        return {"path": path, "boot": self.boot_id, "epoch": cs._export_epoch,
                "windows": windows}

    @staticmethod
    def _export_path(cs) -> str:
        # in the collection's checkpoint namespace but outside the level
        # grammar ("xport" never parses as a level), so the checkpoint
        # listing and pruning pass it by
        return os.path.join(cs.ckpt_dir, f"{cs.ckpt_prefix()}xport.npz")

    async def session_import(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Adopt a migrated or orphaned collection's banked state.

        ``{"path", "boot", "epoch"}`` names a ``session_export`` blob (live
        migration: the blob's stamp must be the announced one, and a stamp
        imports at most once, since applied twice a transfer lands its
        in-flight submissions twice); ``{"level": N}`` names this
        collection's own checkpoint (failover: the dead pair's newest ingest
        checkpoint in the shared store, unstamped).

        Every check runs before anything changes — a torn or corrupt blob,
        another collection's stamp, a stamp that is not the announced one or
        was imported already, a blob that is not ingest-only, another crawl
        radix (either way), a torn ``ing_*`` tail — and a refusal leaves the
        state as it was.  Then the pools are rebuilt and the collection's
        channel is forced to key up again (coin flip and, secure, base OT
        against this pair's peer at the next data-plane verb): OT sessions
        never cross hosts."""
        cs = cs or self._default()
        req = req or {}
        if cs.ckpt_dir is None:
            raise RuntimeError("session_import: no checkpoint dir configured")
        stamp = None
        if req.get("path") is not None:
            path = str(req["path"])
            stamp = (str(req.get("boot", "")), int(req.get("epoch", 0)))
        else:
            path = cs.ckpt_path(int(req["level"]))
        if not os.path.exists(path):
            raise RuntimeError(f"session_import: no blob at {path}")
        try:  # a torn write surfaces as BadZipFile, ValueError or EOFError
            z = await asyncio.to_thread(_load_npz, path)
        except Exception as e:  # every load failure is the same refusal
            raise RuntimeError(f"session_import: corrupt or truncated blob at {path} "
                               f"({type(e).__name__}: {e})") from e
        if "sess" in z and str(z["sess"]) != cs.key:
            raise RuntimeError(f"session_import: blob at {path} is stamped for collection "
                               f"{str(z['sess'])!r}, not {cs.key!r}")
        if stamp is not None:
            got = (str(z.get("xp_boot", "")), int(z.get("xp_epoch", 0)))
            if got != stamp:
                raise RuntimeError(f"session_import: blob at {path} carries stamp {got}, not "
                                   f"the announced export {stamp} (stale file?)")
            if stamp in cs._import_seen:
                raise RuntimeError(f"session_import: export {stamp} was already imported — "
                                   "double-applying a transfer would double-land its "
                                   "in-flight submissions")
        if not ("ing_only" in z and bool(z["ing_only"])):
            raise RuntimeError("session_import: only ingest-form blobs migrate (crawl state "
                               "rebuilds from the pools via window_load); use add_keys + "
                               "tree_restore for a crawl-level checkpoint")
        xp_radix = int(z["radix"]) if "radix" in z else 1
        if xp_radix != self.cfg.crawl_radix_bits:
            raise RuntimeError(f"session_import: blob at {path} was exported under "
                               f"crawl_radix_bits={xp_radix}; this session runs "
                               f"crawl_radix_bits={self.cfg.crawl_radix_bits}")
        parsed = cs.ingest_validate(z, path)
        # -- every check passed: mutate
        if parsed is not None:
            cs.ingest_restore_apply(parsed)
            if taint_guard.enabled():
                # the rebuilt pools are clients' key shares (and sketch
                # material) this host never held before: the sinks refuse them
                for pool in cs._ingest_pools.values():
                    for entry in pool.entries:
                        for leaf in entry:
                            taint_guard.register("CollectionSession._imported_pool_shares",
                                                 leaf)
        else:
            cs._ingest_pools.clear()  # an empty export imports as empty
        if stamp is not None:
            cs._import_seen.add(stamp)
        # plane epoch 0: never keyed, so the next data-plane verb keys the
        # channel against this pair's peer
        cs._ot_snd = cs._ot_rcv = cs._sec_seed = None
        cs.plane_epoch = 0
        cs.obs.count("session_imports")
        windows = sorted(cs._ingest_pools)
        self.emit("fleet.session_imported", server=self.server_id, collection=cs.key,
                  windows=windows, path=path)
        return {"windows": windows}

    async def warmup(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Run, for every requested bucket ``f_buckets`` and every span size
        it implies under ``crawl_shard_nodes`` (none for a whole-level
        secure crawl unless ``secure_spans``), what a crawl at that bucket
        runs (:meth:`_warm_bucket`), with the leader's ``ot_path``.  Touches
        no live state: neither the frontier, nor the OT sessions, nor the
        data plane.  A leader whose ``data_shards`` resolves to another shard
        count than this server's gets a ``warmup.shard_mismatch`` event (the
        server's own shards are warmed).  A shape that any collection of
        this server already warmed is skipped and counted a ladder hit
        (``protocol/tenancy.py``): a new collection on a warmed shape runs
        nothing again.  -> ``{"shapes", "ladder_hits"}``: the
        shapes warmed, the shapes skipped."""
        cs = cs or self._default()
        cs._concat_keys("warmup")
        req = req or {}
        buckets = sorted({int(b) for b in req.get("f_buckets", []) if int(b) > 0})
        ot_path = req.get("ot_path") or self.cfg.ot_path
        whole = (self.cfg.secure_exchange and self.cfg.secure_whole_level
                 and not req.get("secure_spans"))
        want = req.get("data_shards")
        have = 1 if cs._mesh is None else cs._mesh.shards
        if want is not None and int(want) > 0:
            want_shards = smesh._largest_divisor_leq(
                cs._n_clients(), smesh.resolve_data_devices(int(want), self.device))
            if want_shards != have:
                self.emit("warmup.shard_mismatch", server=self.server_id,
                          leader_data_shards=want_shards, server_data_shards=have)
        L = cs._data_len()
        shapes = hits = 0
        with cs.obs.span("warmup"):
            for b in buckets:
                sizes = set() if whole else {
                    hi - lo for lo, hi in collect.shard_spans(b, self.cfg.crawl_shard_nodes)}
                for fb in sorted(sizes | {b}):
                    key = self._warm_key(cs, fb, L, ot_path)
                    if tenancy.warmed(key):
                        hits += 1
                    else:
                        self._warm_bucket(cs, fb, L, ot_path)
                        tenancy.mark_warmed(key)
                        shapes += 1
                    await asyncio.sleep(0)  # the control plane keeps answering
        cs.obs.count("warmup_shapes", shapes)
        if hits:
            cs.obs.count("warmup_ladder_hits", hits)
        # a malicious session warms the same crawl shapes: the JAX server's
        # _warm_sketch pre-compiles the sketch verify's XLA programs, and
        # PyTorch compiles nothing, so there is nothing more to warm
        if self.device.type == "cuda":  # the peer process shares the card
            torch.cuda.empty_cache()
        # the warmup is the build baseline: a fresh kernel build after it is
        # a named event, and the post-warmup watermark is the crawl's floor
        obsdevmem.note_warmup_done()
        obsdevmem.sample(cs.obs, phase="warmup")
        return {"shapes": shapes, "ladder_hits": hits}

    def _warm_key(self, cs, fb: int, L: int, ot_path: str) -> tuple:
        """The warm ladder's key of one shape: everything that changes a
        launch's shape or path — the server (its boot id: servers sharing a
        process, as in the CPU tests, each warm as their own processes
        would) and its device, the batch shape, the bucket, the secure
        exchange and its ``ot_path`` (so S through d and the radix, W
        through the field of each round), the data shards and the kernel
        stage's shard budget."""
        return ("warm", self.boot_id, str(self.device), tuple(cs._kb().cw_seed.shape),
                cs._n_clients(), fb, L, bool(self.cfg.secure_exchange), str(ot_path),
                int(self.cfg.crawl_radix_bits), 1 if cs._mesh is None else cs._mesh.shards,
                int(self.cfg.secure_kernel_shards))

    def _warm_bucket(self, cs, fb: int, L: int, ot_path: str) -> None:
        """A throwaway root frontier of ``fb`` slots through the rounds a
        crawl runs: the full-radix round with the child cache and the tail
        round without (one round when it is the whole crawl); then the
        count, or in secure mode the level's whole 2PC chain
        (``secure.warm_level_kernels``, or its row-sharded twin where the
        live level binds the kernel stage to the data shards) in FE62 or,
        for the tail, F255.  With data shards every stage runs per shard,
        as the live crawl does."""
        mesh = cs._mesh
        keys = cs._shards(cs.keys)
        d, N = keys[0].cw_seed.shape[1], cs._n_clients()
        k = self.cfg.crawl_radix_bits
        frs = [collect.tree_init(kb, fb) for kb in keys]
        base_last = k * ((L - 1) // k)
        steps = ([(min(k, L), True)] if base_last == 0
                 else [(k, False), (L - base_last, True)])
        alive = cs.alive_keys
        if alive is None:
            alive = torch.ones(N, dtype=torch.bool, device=self.device)
        for r, last in steps:
            # the child cache is dropped at once: the tail round is built without it
            packed = [collect.expand_share_bits_radix(kb, fr, base_last if last else 0, r,
                                                      want_children=not last)[0]
                      for kb, fr in zip(keys, frs)]
            field = F255 if last else FE62
            if self.cfg.secure_exchange:
                ks = (None if mesh is None else
                      mesh.kernel_bind(fb * (1 << (d * r)) * N, 2 * d * r,
                                       self.cfg.secure_kernel_shards))
                if ks is not None:
                    secure.warm_level_kernels_sharded(ks, packed, d, fb, N, field, ot_path, r)
                else:
                    whole = packed[0] if mesh is None else mesh.gather(Sharded(packed, 1))
                    secure.warm_level_kernels(whole, d, field, ot_path, r)
            elif mesh is not None:
                # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (warmup only: deliberately mirrors the live wire round trip, off the measured clock)
                mesh.counts_by_pattern(packed, packed, collect.pattern_masks_radix(d, r),
                                       alive, frs[0].alive).cpu()
            else:
                # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (as above)
                collect.counts_by_pattern(packed[0], packed[0],
                                          collect.pattern_masks_radix(d, r), alive,
                                          frs[0].alive).cpu()

    # -- recovery verbs (no reference analogue: its only recovery verb is
    # reset, server.rs:64-69) ------------------------------------------------

    async def status(self, _req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """The supervising leader's probe: the boot id tells it whether this
        is the process it knew (replay is safe) or a restart (state gone:
        restore), the dedup hits that no verb ran twice; for the calling
        collection its ingest front door's health (``ingest``: per-window
        occupancy, the unsealed queue depth, the admit, shed and reject
        counters) and its data shards' (``mesh``, whose ``faults`` tells the
        leader a device loss from a server loss); every collection's row
        with the tenant scheduler's figures (``sessions``); and the fleet's
        (``fleet``: the pair this server is half of, its boot id, the
        calling collection's exports and imports, and the placement signals
        ``fleet.FleetDirectory.note_load`` takes); and the calling
        collection's latency quantiles (``slo``: per-level crawl, per-verb,
        seal to hitters), and every alert fired in this process (``alerts``).
        Each probe samples device memory onto the server's registry, then
        runs the session alert rules over the rows just built and the
        registry rules over every live registry: fire-once per (rule,
        subject), so probes of a stalled collection give one alert."""
        cs = cs or self._default()
        obsdevmem.sample(self.obs, phase="status")
        sess = self.sessions_status()
        obsalerts.evaluate_sessions(sess["per_session"], source=f"server{self.server_id}")
        obsalerts.evaluate_registries()
        return {"boot_id": self.boot_id, "collection": cs.key,
                "clock": round(time.time(), 6),
                "has_keys": cs.keys is not None or bool(cs.keys_parts),
                "has_frontier": cs.frontier is not None,
                "dedup_hits": int(self.obs.counter_value("dedup_hits")),
                "plane_resets": int(self.obs.counter_value("plane_resets")),
                "ckpt_levels": cs.ckpt_levels(), "ingest": cs.ingest_status(),
                "mesh": cs.mesh_status(), "sessions": sess,
                "fleet": {"pair": os.environ.get("FHH_FLEET_PAIR", ""),
                          "boot_id": self.boot_id,
                          "session_exports": int(cs.obs.counter_value("session_exports")),
                          "session_imports": int(cs.obs.counter_value("session_imports")),
                          "load": self._sched.fleet_load()},
                "slo": cs.obs.hists_summary(), "alerts": obsalerts.status_section()}

    def sessions_status(self) -> dict:  # fhh-race: atomic (read-only rollup over the session table in one event-loop slice; per-session reads are point-in-time probes for an operator, not protocol state)
        """The ``sessions`` section of ``status`` and ``server.exit`` (JAX
        rpc.py:1969-2005): the live collections, one row each (the verb it
        runs and its level, the unsealed queue depth, the replay-cache
        entries of its leaders, its checkpoint levels, the plane epoch its
        channel was keyed at, the seconds since it last finished a verb, and
        its flat counters from its registry, :func:`sessions.summary`, which
        sum to the server's), and the tenant scheduler's device turns and
        stall fills.  A point-in-time probe for an operator, read without the
        locks (also from the exporter's scrape thread)."""
        dedup: dict = {}
        with guards.unguarded("status rollup: point-in-time operator probe over the replay "
                              "table and every collection's rows, without their locks"):
            for sess in list(self._sessions.values()):
                dedup[sess.collection] = dedup.get(sess.collection, 0) + len(sess.cache)
            now = time.monotonic()
            rows = {key: {"phase": cs.phase, "level": cs.level,
                          "queue_depth": sum(p.keys for p in list(cs._ingest_pools.values())
                                             if not p.sealed),
                          "dedup_entries": dedup.get(key, 0), "ckpt_levels": cs.ckpt_levels(),
                          "has_frontier": cs.frontier is not None,
                          "plane_epoch": cs.plane_epoch,
                          "last_progress_s": round(max(0.0, now - cs.last_progress), 3),
                          "counters": sessions.summary([cs.obs.report()])}
                    for key, cs in self._table.items()}
        return {"count": len(self._table), "scheduler": self._sched.stats(),
                "per_session": rows}

    async def tree_checkpoint(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Persist the crawl state after the round based at ``level``: the
        frontier (plane-major: ``planar`` True), node and client liveness,
        stamped with the key fingerprint, the level, the collection
        (``sess``) and the crawl radix, and in malicious mode the sketch
        state (:meth:`sessions.CollectionSession._sketch_blob`) — the JAX
        server's blob, field for field, in the collection's own namespace.
        A sketch crawl banks one at level -1 too, after ``tree_init``,
        before any Beaver slab opens.  Keys are not in it: the leader
        re-uploads them to a restarted server.  The ingest pools ride every
        blob (``ing_*``: entries, recorded verdicts, quota ledgers, the
        reservoir's state); with ``ingest_only``, or with pools and no
        frontier (between windows), the blob is ingest-only (``ing_only``),
        the rollback point of a window's recovery.  Written to a temporary
        file and renamed, so a crash mid-write leaves the previous
        checkpoint whole; the two newest levels are kept."""
        cs = cs or self._default()
        if self.ckpt_dir is None:
            raise RuntimeError("tree_checkpoint: no checkpoint dir configured "
                               "(start the server with FHH_CKPT_DIR set)")
        pools = cs._ingest_pools
        ing_only = bool((req or {}).get("ingest_only"))
        if cs.frontier is None and not pools:
            raise RuntimeError("tree_checkpoint before tree_init")
        if ing_only and not pools:
            raise RuntimeError("tree_checkpoint: no ingest pools to persist")
        level = int(req["level"])
        t0 = time.perf_counter()
        if cs.frontier is not None and not ing_only:
            fr = (cs.frontier if cs._mesh is None
                  else cs._mesh.gather_frontier(cs.frontier))
            st = fr.states
            as_np = lambda t: t.cpu().numpy()
            blob = {"seed": words_to_numpy(st.seed), "bit": as_np(st.bit),
                    "y_bit": as_np(st.y_bit), "alive": as_np(fr.alive),
                    "alive_keys": as_np(cs.alive_keys), "planar": np.bool_(True),
                    "keys_fp": cs._keys_fp()}
            if cs._sketch is not None:
                blob.update(cs._sketch_blob())
        else:
            blob = {"ing_only": np.bool_(True)}
        blob.update(level=np.int64(level), sess=np.str_(cs.key),
                    radix=np.int64(self.cfg.crawl_radix_bits))
        cs.ingest_ckpt_fields(blob)
        path = cs.ckpt_path(level)
        tmp = f"{path}.tmp{os.getpid()}"

        def write():
            with open(tmp, "wb") as f:
                np.savez(f, **blob)
            os.replace(tmp, path)
            cs.ckpt_prune()

        await asyncio.to_thread(write)
        dt = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        cs.obs.count("checkpoint_writes", level=level)
        cs.obs.count("checkpoint_bytes", nbytes, level=level)
        cs.obs.timer_add("checkpoint_write", dt, level=level)
        self.emit("resilience.server_checkpoint", server=self.server_id,
                  collection=cs.key, level=level, path=path, bytes=nbytes,
                  seconds=dt)
        return {"level": level}

    async def tree_restore(self, req, cs=None) -> dict:  # fhh-race: holds=_verb_lock (dispatched only by _dispatch, which holds the session's verb lock; sanitizer-validated)
        """Reload the :meth:`tree_checkpoint` of the level the leader names
        and return it (the crawl goes on at the round after it).  Needs the
        keys: still held, or re-uploaded after a restart.  Every check runs
        before any state changes — a missing, corrupt or truncated file,
        another collection's or crawl radix's stamp, missing fields, another
        key batch, a file renamed to another level, a level past the tree,
        another client count, sketch state where the session has none (or
        none where it has), torn ``sk_*`` or ``ing_*`` fields — and a
        refusal leaves the live state as it was.  An ingest-only blob
        restores the pools alone and needs no keys (the pools are the
        keys); every other blob restores its pools with the frontier.  A
        blob of the interleaved layout (``planar`` False, a JAX server on
        the XLA engine) is carried to the plane-major one."""
        cs = cs or self._default()
        if self.ckpt_dir is None:
            raise RuntimeError("tree_restore: no checkpoint dir configured")
        want = int(req["level"])
        path = cs.ckpt_path(want)
        if not os.path.exists(path):
            raise RuntimeError(f"tree_restore: no checkpoint at {path}")
        t0 = time.perf_counter()
        try:  # a torn write surfaces as BadZipFile, ValueError or EOFError
            z = await asyncio.to_thread(_load_npz, path)
        except Exception as e:  # every load failure is the same refusal
            raise RuntimeError(f"tree_restore: corrupt or truncated checkpoint at {path} "
                               f"({type(e).__name__}: {e})") from e
        if "sess" in z and str(z["sess"]) != cs.key:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is stamped for collection "
                               f"{str(z['sess'])!r}, not {cs.key!r} (renamed across "
                               "session namespaces?)")
        saved_radix = int(z["radix"]) if "radix" in z else 1  # unstamped blobs are radix 1
        if saved_radix != self.cfg.crawl_radix_bits:
            raise RuntimeError(f"tree_restore: checkpoint at {path} was written under "
                               f"crawl_radix_bits={saved_radix}; this session runs "
                               f"crawl_radix_bits={self.cfg.crawl_radix_bits} — its level grid "
                               "never visits the blob's frontier depth")
        if "ing_only" in z and bool(z["ing_only"]):
            if int(z.get("level", want)) != want:
                raise RuntimeError(f"tree_restore: checkpoint at {path} is stamped level {want} "
                                   f"but records level {int(z['level'])} (renamed or tampered "
                                   "file)")
            parsed = cs.ingest_validate(z, path)
            if parsed is None:
                raise RuntimeError(f"tree_restore: ingest-only checkpoint at {path} carries no "
                                   "ingest pools (truncated write?)")
            cs.ingest_restore_apply(parsed)
            dt = time.perf_counter() - t0
            cs.obs.count("checkpoint_restores", level=want)
            cs.obs.timer_add("checkpoint_restore", dt, level=want)
            self.emit("resilience.server_restore", server=self.server_id,
                      collection=cs.key, level=want, seconds=dt, ingest_only=True)
            return {"level": want}
        cs._concat_keys("tree_restore")
        required = {"seed", "bit", "y_bit", "alive", "alive_keys", "level", "planar",
                    "keys_fp"}
        missing = required - set(z)
        if missing:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is missing fields "
                               f"{sorted(missing)} (truncated write?)")
        if not np.array_equal(z["keys_fp"], cs._keys_fp()):
            raise RuntimeError("tree_restore: checkpoint was written under a different key "
                               "batch — re-upload the original keys")
        level = int(z["level"])
        L, n = cs._data_len(), cs._n_clients()
        if level != want:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is stamped level {want} "
                               f"but records level {level} (renamed or tampered file)")
        if level >= L - 1:
            raise RuntimeError(f"tree_restore: checkpoint level {level} is deeper than this "
                               f"key batch's tree (data_len={L}) — wrong collection")
        if z["alive_keys"].shape[0] != n:
            raise RuntimeError("tree_restore: checkpoint client count != key batch")
        cs._check_sketch_blob(z, path)
        parsed_ing = cs.ingest_validate(z, path)  # None: a blob with no pools
        # -- every check passed: mutate.  With data shards the frontier is
        # split again from the host blob: a lost device is recovered by
        # placement, not by a restart
        dev = self.device if cs._mesh is None else torch.device("cpu")
        as_bool = lambda a: tensor_from_numpy(a, dev, bool)
        if bool(z["planar"]):
            states = EvalState(seed=words_from_numpy(z["seed"], dev), bit=as_bool(z["bit"]),
                               y_bit=as_bool(z["y_bit"]))
        else:
            states = collect.states_from_numpy(
                EvalState(seed=z["seed"], bit=z["bit"], y_bit=z["y_bit"]), dev)
        cs.alive_keys = tensor_from_numpy(z["alive_keys"], self.device, bool)
        frontier = collect.Frontier(states=states, alive=as_bool(z["alive"]))
        cs.frontier = (frontier if cs._mesh is None
                       else cs._mesh.shard_frontier(frontier))
        cs.children = cs.last_shares = None
        cs.clear_spans()
        if cs._has_sketch():
            cs._restore_sketch(z)
        if parsed_ing is not None:
            cs.ingest_restore_apply(parsed_ing)
        dt = time.perf_counter() - t0
        cs.obs.count("checkpoint_restores", level=level)
        cs.obs.timer_add("checkpoint_restore", dt, level=level)
        self.emit("resilience.server_restore", server=self.server_id,
                  collection=cs.key, level=level, seconds=dt,
                  planar=bool(z["planar"]))
        return {"level": level}

    async def plane_reset(self, _req, cs=None) -> bool:  # fhh-race: holds=_verb_lock (dispatched by _dispatch under the SERVER infra lock — the plane is shared infrastructure across sessions; sanitizer-validated)
        """Re-establish the data plane after a peer loss: server 0 drops its
        transport and redials under ``DIAL_POLICY``; server 1 re-accepts on
        its listener, which is still bound.  The plane is shared: the new
        transport bumps the mux epoch, so every collection re-keys its
        channel at its next data-plane verb, and a collection caught
        mid-exchange fails that verb, for its own leader to recover.  Runs
        under the server's lock, not a collection's."""
        if self.server_id != 0:
            return True
        if self._peer_writer is not None and not self._peer_writer.is_closing():
            self._peer_writer.close()
        await self._dial_peer()
        self.obs.count("plane_resets")
        self.emit("resilience.plane_reset", server=self.server_id)
        return True

    async def plane_break(self, _req, cs=None) -> bool:
        """Close this server's end of the data plane without redialing: the
        pipelined leader's quiesce.  Dispatched outside the verb locks, so it
        can break a verb wedged on a plane recv while holding its lock (a
        span that reached one server only): the mux fails every blocked
        recv, the verb answers its error, and the leader's ``plane_reset``
        follows."""
        w = self._peer_writer
        if w is not None and not w.is_closing():
            w.close()
        self.obs.count("plane_breaks")
        self.emit("resilience.plane_break", server=self.server_id)
        return True

    @staticmethod
    def _prune_args(req):
        """(parent_idx int64[F'], pattern bits bool[F', r, d], n_alive): the
        wire's ``[F', d]`` (radix 1) or ``[F', r, d]`` (a fused round)."""
        # fhh-lint: disable=host-sync-in-hot-loop (wire input: host numpy)
        parent = np.asarray(req["parent_idx"], np.int64)
        # fhh-lint: disable=host-sync-in-hot-loop (wire input: host numpy)
        pat = np.asarray(req["pattern_bits"], bool)
        if pat.ndim == 2:
            pat = pat[:, None, :]
        if pat.ndim != 3:
            raise ValueError(f"pattern bits shaped {list(pat.shape)}: want [F', d] or "
                             "[F', r, d]")
        return parent, pat, int(req["n_alive"])

    @staticmethod
    def _parse_shard(req):
        s = (req or {}).get("shard")
        return None if s is None else (int(s[0]), int(s[1]))

    # -- one level: the device stage, then the exchange --------------------------

    def _do_expand(self, cs, level: int, last: bool, shard) -> dict:  # fhh-race: atomic (dispatch-only device work, never suspends; called both under the session's verb lock and from the frame-arrival pre-expand)
        """The device half of one crawl verb: the expansion of the frontier
        view, per data shard on its clients (and in secure mode its
        equality strings: row-sharded over the kernel stage's shards, or
        gathered onto the first shard when the level binds one).
        Dispatches device work and never touches the data plane."""
        frontier = cs._frontier_view(shard)
        r = cs.crawl_radix(level)
        outs = [collect.expand_share_bits_radix(k, f, level, r, want_children=not last)
                for k, f in zip(cs._shards(cs.keys), cs._shards(frontier))]
        packed = cs._one([p for p, _ in outs])
        out = {"packed": packed, "children": cs._one([c for _, c in outs]),
               "frontier": frontier}
        if self.cfg.secure_exchange:  # strings of S' = 2·d·r bits
            d = cs._kb().cw_seed.shape[1]
            if cs._mesh is not None:
                F, N, C = frontier[0].f_bucket, cs._mesh.n_clients, 1 << (d * r)
                ks = cs._mesh.kernel_bind(F * C * N, 2 * d * r, self.cfg.secure_kernel_shards)
                if ks is not None:
                    out.update(flat=kernel_shard.shard_flat(ks, packed, d, F, N, r),
                               dims=(F, C, N, 2 * d * r), kernel=ks)
                    del out["packed"]
                    return out
                t0 = time.perf_counter()
                packed = cs._mesh.gather(Sharded(packed, 1))
                cs.obs.timer_add("kernel_gather", time.perf_counter() - t0, level=level)
                cs.obs.count("kernel_gathers", level=level)
            strs = secure.child_strings_radix(packed, d, r)
            F, C, N, S = strs.shape
            out.update(flat=strs.reshape(F * C * N, S), dims=(F, C, N, S))
            del out["packed"]
        return out

    def _expand_stage(self, cs, level: int, last: bool, shard) -> dict:
        hit = cs._expand_ready.pop((last, level, shard), None)
        if hit is not None:
            cs.obs.count("pipeline_expand_hits", level=level)
            return hit
        return self._do_expand(cs, level, last, shard)

    async def _device_stage(self, cs, level: int, last: bool, shard) -> dict:
        """The expand stage in a device turn (``tenancy.TenantScheduler``):
        FIFO across collections, a stall fill when another collection waits
        on the wire.  The turn brackets the stage alone, never an exchange:
        two servers granting turns in opposite orders must not wait on each
        other.  A span pre-expanded at its frame's arrival was counted then."""
        pre = (last, level, shard) in cs._expand_ready
        async with self._sched.device_turn(cs.key, count=not pre):
            return self._expand_stage(cs, level, last, shard)

    def _maybe_pre_expand(self, cs, verb: str, req) -> None:  # fhh-race: atomic (frame-arrival prefetch: reads frontier/keys and stashes in one event-loop slice; every frontier mutation clears the stash before the next slice)
        """Frame arrival of a span's crawl verb, before the verb lock: run
        its expansion now, while an earlier span holds the lock on the data
        plane.  A prefetch only: any failure here leaves the verb to
        recompute, and surface the error, under the lock."""
        if verb not in ("tree_crawl", "tree_crawl_last"):
            return
        shard = self._parse_shard(req)
        if shard is None or cs.keys is None or cs.frontier is None:
            return
        if shard[1] > cs._f_bucket():
            return
        key = (verb == "tree_crawl_last", int(req["level"]), shard)
        if key in cs._expand_ready or len(cs._expand_ready) >= 32:
            return
        t0 = time.perf_counter()
        try:
            cs._expand_ready[key] = self._do_expand(cs, key[1], key[0], shard)
        except Exception:  # fhh-lint: disable=broad-except (prefetch only: the verb recomputes under the lock and surfaces the real error to the leader)
            cs._expand_ready.pop(key, None)
            return
        # a dispatch while another collection's span is on the wire is the
        # gap tenancy fills; its seconds go to the fss phase the verb would
        # otherwise have spent them in (no span: another verb's is active)
        self._sched.note_dispatch(cs.key)
        cs.obs.timer_add("fss", time.perf_counter() - t0, level=key[1])
        cs.obs.count("pipeline_pre_expands", level=key[1])

    async def _crawl(self, cs, verb: str, req, last: bool) -> np.ndarray:
        if cs.frontier is None:
            raise RuntimeError(f"{verb} before tree_init")
        level = int(req["level"])
        shard = self._parse_shard(req)
        await self._ensure_session_plane(cs)
        field = F255 if last else FE62
        cs.obs.count("levels", level=level)
        # FHH_PROFILE with FHH_PROFILE_LEVELS: this level's device work in a
        # torch.profiler capture, recorded with the live trace id
        if self.cfg.secure_exchange:
            with obstrace.profile_capture("level", level=level):
                shares = await self._mesh_guard(cs, level, lambda: self._crawl_secure(
                    cs, level, field, last, int(req.get("garbler", 0)), req.get("ot_path"),
                    shard))
            cs.obs.count("levels_done", level=level)
            return shares
        with obstrace.profile_capture("level", level=level):
            counts = await self._mesh_guard(cs, level,
                                            lambda: self._crawl_trusted(cs, level, last, shard))
        cs.obs.count("levels_done", level=level)
        # trusted mode: both servers hold these counts; the shared mask is a
        # wire-format shim for the leader's v0 - v1, not a secret
        F, C = counts.shape
        r = cs._mask_rows(level, shard, C, f255=last)
        if self.server_id == 1:
            return r
        if last:
            c = np.zeros((F, C, 8), np.uint32)
            c[..., 0] = counts
            return F255.np_add(c, r)
        return FE62.np_add(counts.astype(np.uint64), r)

    async def _mesh_guard(self, cs, level: int, thunk):
        """A crawl verb's level under device-loss containment (JAX
        rpc.py:1163-1192): the mesh chaos schedule fires first, before any
        data-plane I/O of the level, and a device fault is recovered in
        place (:meth:`_mesh_recover`) and the level run again inside the
        same verb, so the peer exchanges once and the leader sees a slow
        verb, not a fault.  Without data shards a fault is the verb's
        error."""
        try:
            if self._mesh_chaos is not None:
                self._mesh_chaos.before_level(cs, int(level))
            return await thunk()
        except reschaos.MeshFaultError as err:
            if cs._mesh is None:
                raise
            await self._mesh_recover(cs, int(level), err)
            return await thunk()

    async def _mesh_recover(self, cs, level: int, err) -> None:
        """After a device fault: a lost device (``state_lost``) takes the
        device state with it, so the keys are rebuilt from the kept chunks
        and the frontier re-sharded from the collection's checkpoint of
        level - 1 (``tree_restore``); a dropped shard is only re-run.  With
        no such checkpoint the data plane is closed (the peer's half of the
        level fails instead of waiting for this one) and the fault goes to
        the leader."""
        cs.obs.count("mesh_faults", level=level)
        cs._expand_ready.clear()  # a pre-expanded dispatch is suspect
        state_lost = bool(getattr(err, "state_lost", False))
        if state_lost or cs.frontier is None:
            prev = level - 1
            if self.ckpt_dir is None or prev not in cs.ckpt_levels():
                if self._peer_writer is not None and not self._peer_writer.is_closing():
                    self._peer_writer.close()
                raise RuntimeError(f"mesh device lost at level {level} with no level-{prev} "
                                   "checkpoint to re-shard from") from err
            cs.keys = None  # device-resident: lost with the shard
            await self.tree_restore({"level": prev}, cs)
            cs.obs.count("mesh_reshards", level=level)
        cs.obs.count("shards_rerun", level=level)
        self.emit("resilience.mesh_reshard", server=self.server_id,
                  collection=cs.key, level=level, state_lost=state_lost,
                  error=str(err))

    def _level_done(self, cs, level: int, fss, gc_ot, field) -> None:
        """A level's three exited spans: the ``level.phases`` debug line and
        the per-level latency histogram, from this pass's seconds (the
        registry's totals would count a re-run level twice); then, on the
        card, a memory sample."""
        obs.emit("level.phases", severity="debug", server=self.server_id,
                 collection=cs.key, level=level, fss_s=fss.seconds, gc_ot_s=gc_ot.seconds,
                 field_s=field.seconds)
        cs.obs.observe("level_latency", fss.seconds + gc_ot.seconds + field.seconds)
        # on the card, one allocator query a level (a port-only sample
        # point: the JAX server samples at status and warmup), so the
        # watermark sees the crawl; on the CPU a sample reads 0 bytes
        if self.device.type == "cuda":
            obsdevmem.sample(cs.obs)

    def _reduce_span(self, cs, level: int):
        """With data shards, the per-shard reduction and its readback run
        in an ``ici_reduce`` span (JAX rpc.py:912-930)."""
        if cs._mesh is None:
            return contextlib.nullcontext()
        cs.obs.gauge("data_shards", cs._mesh.shards, level=level)
        # fhh-lint: disable=span-discipline (returned to the caller's with statement, which enters and exits it)
        return cs.obs.span("ici_reduce", level=level)

    async def _crawl_trusted(self, cs, level: int, last: bool, shard) -> np.ndarray:
        """Swap the packed share bits uint32[F, N] of the frontier (or the
        span) with the peer and count -> int64[F, 2^(d·r)] (ref:
        collect.rs:945-964), in the reference's three phase spans."""
        with cs.obs.span("fss", level=level) as sp_fss:
            ex = await self._device_stage(cs, level, last, shard)
            packed, frontier = ex["packed"], ex["frontier"]
            mesh = cs._mesh
            if mesh is None:
                mine = await _fetch_words(packed)
            else:  # per-shard readbacks, assembled by position
                mine = (await asyncio.to_thread(kernel_shard.assemble,
                                                Sharded(packed, 1))).view(np.uint32)
            cs.obs.count("device_fetches", len(cs._shards(packed)))
        with cs.obs.span("gc_ot", level=level) as sp_gc:
            peer = await self._swap(cs, mine)
        with cs.obs.span("field", level=level) as sp_field:
            if peer.shape != mine.shape:
                raise RuntimeError(f"level {level}: the peer's share bits are shaped "
                                   f"{peer.shape}, this server's {mine.shape}")
            masks = collect.pattern_masks_radix(cs._kb().cw_seed.shape[1],
                                                cs.crawl_radix(level))
            with self._reduce_span(cs, level):
                if mesh is None:
                    dev_counts = collect.counts_by_pattern(
                        packed, words_from_numpy(peer, self.device), masks, cs.alive_keys,
                        frontier.alive)
                else:
                    dev_counts = mesh.counts_by_pattern(packed, words_from_numpy(peer, "cpu"),
                                                        masks, cs.alive_keys,
                                                        frontier[0].alive)
                # fhh-lint: disable=host-sync-in-hot-loop (the level's one readback, off the event loop and counted as device_fetches; counts are int64, not the uint32 words _fetch_words moves)
                counts = await asyncio.to_thread(lambda: dev_counts.cpu().numpy())
                cs.obs.count("device_fetches")
        self._level_done(cs, level, sp_fss, sp_gc, sp_field)
        cs._stash_children(level, shard, ex["children"])
        return counts

    async def _crawl_secure(self, cs, level: int, field, last: bool, garbler: int,
                            ot_path, shard) -> np.ndarray:
        """The whole-level (or span) 2PC (ref: collect.rs:419-501): the
        evaluator sends its extension's ``u``, the garbler answers with its
        one planar message, each server sums its additive shares per (node,
        pattern).  No share bit crosses the wire.  The ``gc_ot`` span splits
        into the secure steps ``otext``, ``garble``/``eval`` and ``b2a``
        (device-stream seconds on the card, every one present at every
        level, as the JAX server's)."""
        dev = self.device
        clock = PhaseClock(dev)
        with cs.obs.span("fss", level=level) as sp_fss:
            ex = await self._device_stage(cs, level, last, shard)
            flat, ks = ex["flat"], ex.get("kernel")
            F, C, N, S = ex["dims"]
            B = F * C * N
            cs.obs.count("gc_tests", B, level=level)
            cs.obs.gauge("ot_batch_size", B * S, level=level)
        with cs.obs.span("gc_ot", level=level) as sp_gc:
            w = secure.alive_weight(cs._shards(ex["frontier"])[0].alive, cs.alive_keys, C)
            # the crawl counter keeps every garbling's randomness fresh if a
            # leader re-crawls a level without a reset
            cs._crawl_ctr += 1
            gseed = secure.derive_seed(cs._sec_seed, 1, level, cs._crawl_ctr)
            bseed = secure.derive_seed(cs._sec_seed, 2, level, cs._crawl_ctr)
            path = secure.ot_path(S, ot_path or self.cfg.ot_path)
            cs.obs.count(f"ot_path_{path}", level=level)
            if cs._mesh is not None:  # the kernel stage's shards (1: the gather path)
                cs.obs.gauge("kernel_shards", 1 if ks is None else ks.k, level=level)
            if ks is not None:  # row-sharded over the data shards: the same wire
                vals = await self._secure_sharded(cs, ks, flat, gseed, bseed, field, garbler,
                                                  path, clock, level)
            elif self.server_id == garbler:  # garbler = OT-extension sender
                u = words_from_numpy(await self._dp_recv(cs), dev)
                msg, vals = secure.gb_step_level(cs._ot_snd, u, flat, gseed, bseed, field,
                                                 garbler, path, phase=clock)
                del u
                cs.obs.count("device_fetches", level=level)
                await self._dp_send(cs, await _fetch_words(msg))
                del msg
            else:  # evaluator = OT-extension receiver
                u, t_rows, idx0 = secure.ev_step1_fused(cs._ot_rcv, flat, phase=clock)
                cs.obs.count("device_fetches", level=level)
                await self._dp_send(cs, await _fetch_words(u))
                del u
                msg = words_from_numpy(await self._dp_recv(cs), dev)
                vals = secure.ev_open_level(t_rows, flat, msg, B, S, field, idx0, path,
                                            phase=clock)
                del t_rows, msg
            del flat, ex["flat"]
        with cs.obs.span("field", level=level) as sp_field:
            with self._reduce_span(cs, level):
                if ks is not None:
                    sh = kernel_shard.share_sums(ks, field, vals, w, F, C, N)
                else:  # whole values on one device: the gather path too
                    sh = secure.node_share_sums(
                        field, vals.reshape((F, C, N) + field.limb_shape), w)
                del vals
                shares = await asyncio.to_thread(_share_wire, field, sh)
                cs.obs.count("device_fetches", level=level)
        spent = clock.settle()
        for name in ("otext", "garble", "eval", "b2a"):
            cs.obs.timer_add(name, spent.get(name, 0.0), level=level)
        self._level_done(cs, level, sp_fss, sp_gc, sp_field)
        cs._stash_children(level, shard, ex["children"])
        return shares

    async def _secure_sharded(self, cs, ks, flat, gseed, bseed, field, garbler: int,
                              path: str, clock, level: int):
        """The row-sharded twin of the whole-level exchange
        (``parallel/kernel_shard.py``, JAX rpc.py:1023-1110): extension,
        payload pair and equality kernel per kernel shard; the frames read
        back per shard and are assembled by position.  -> the additive
        shares, per shard."""
        kphase = "b2a" if path == "ot2s" else ("garble" if self.server_id == garbler else "eval")
        if self.server_id == garbler:
            u_np = await self._dp_recv(cs)
            with clock("otext"):
                q, idx0 = kernel_shard.snd_extend(ks, cs._ot_snd, u_np)
            with clock(kphase):
                planes, vals = kernel_shard.gb_kernel(ks, cs._ot_snd.s_block, q, flat, gseed,
                                                      bseed, field, garbler, path, idx0)
            del q
            cs.obs.count("device_fetches", ks.k, level=level)
            await self._dp_send(cs, await asyncio.to_thread(kernel_shard.msg_wire, ks, planes))
            return vals
        with clock("otext"):
            u, t_rows, idx0 = kernel_shard.rcv_extend(ks, cs._ot_rcv, flat)
        cs.obs.count("device_fetches", ks.k, level=level)
        await self._dp_send(cs, await asyncio.to_thread(kernel_shard.u_wire, ks, u))
        del u
        msg = await self._dp_recv(cs)
        with clock(kphase):
            return kernel_shard.ev_open(ks, t_rows, flat, msg, field, path, idx0)

    # -- data plane: (collection, payload) frames, received through the mux ---

    async def _dp_send(self, cs, obj) -> None:
        cs.obs.count("data_msgs_sent")

        def count(n: int) -> None:
            cs.obs.count("data_bytes_sent", n)
            self._note_frame(n)

        # under tracing the frame carries this verb's (trace id, span id), so
        # the peer's arrival instant parents under the sender's span
        hdr = obstrace.wire_tag() if obstrace.enabled() else None
        frame = (cs.key, _readonly(obj)) if hdr is None else (cs.key, _readonly(obj), hdr)
        await _send(self._peer_writer, frame, count=count)

    async def _dp_recv(self, cs):
        # a collection's wire wait is the gap another collection's device
        # turn fills
        with self._sched.wire_wait(cs.key):
            return await self._plane.recv(cs.key)

    async def _swap(self, cs, obj):
        """Role-ordered exchange on the collection's channel: server 0 writes
        first, server 1 reads first (symmetric send-then-recv deadlocks once
        frames outgrow the socket buffers)."""
        if self.server_id == 0:
            await self._dp_send(cs, obj)
            return await self._dp_recv(cs)
        peer = await self._dp_recv(cs)
        await self._dp_send(cs, obj)
        return peer

    def _keyed(self, cs) -> bool:
        return cs.plane_epoch == self._plane.epoch and (
            cs._ot_snd is not None or not self.cfg.secure_exchange)

    async def _ensure_session_plane(self, cs) -> None:
        """Key the collection's channel on the current plane, once per
        (collection, plane epoch) (JAX rpc.py:3144-3180): the coin flip,
        then in secure mode the base-OT sessions, all on the collection's
        own channel, so many collections key up at once on one socket.  A
        new transport bumps the epoch, and each collection re-keys at its
        next data-plane verb.  The caller holds the collection's verb lock,
        and both servers reach this from the same leader verb, so the
        channel carries matching handshake frames."""
        if self._keyed(cs):
            return
        with cs.obs.span("plane_handshake"):
            # the coin flip: the XOR of both sides' 16 bytes is this
            # channel's sketch seed, uniform if either side is honest and
            # never a public constant (a client that predicts the challenge
            # forges a pass); sent in every mode, since a JAX peer sends and
            # awaits it
            mine = secrets.token_bytes(16)
            theirs = await self._swap(cs, mine)
            cs._sketch_seed = np.frombuffer(bytes(a ^ b for a, b in zip(mine, theirs)),
                                            "<u4").copy()
            taint_guard.register("CollectionSession._sketch_seed", cs._sketch_seed)
            if self.cfg.secure_exchange:
                await self._setup_secure(cs)
        cs.plane_epoch = self._plane.epoch
        obs.emit("plane.session_keyed", severity="debug", server=self.server_id,
                 collection=cs.key, epoch=cs.plane_epoch)

    async def _setup_secure(self, cs) -> None:
        """Two base-OT sessions seeding the collection's IKNP extension, one
        per garbling direction: in session ``g`` server ``g`` is the
        extension sender and plays base-OT receiver with its secret ``s``.
        The elliptic-curve work runs off the event loop."""
        for g in (0, 1):
            if self.server_id == g:
                s_bits = otext.fresh_s_bits()
                a_msg = await self._dp_recv(cs)
                br = baseot.BaseOtReceiver(s_bits)
                await self._dp_send(cs, await asyncio.to_thread(br.round1, a_msg))
                seeds = await asyncio.to_thread(br.seeds)
                cs._ot_snd = otext.OtExtSender(s_bits, seeds, self.device)
            else:
                bs = baseot.BaseOtSender()
                await self._dp_send(cs, bs.round1())
                r_msgs = await self._dp_recv(cs)
                s0, s1 = await asyncio.to_thread(
                    lambda: bs.seeds([baseot.decompress(m) for m in r_msgs]))
                cs._ot_rcv = otext.OtExtReceiver(s0, s1, self.device)
        cs._sec_seed = np.frombuffer(secrets.token_bytes(16), "<u4").copy()
        taint_guard.register("CollectionSession._sec_seed", cs._sec_seed)

    # -- serving --------------------------------------------------------------

    async def _run_verb(self, cs, verb: str, req):
        """Run one verb on collection ``cs``; every failure is a response.
        ``add_keys`` (it appends and never suspends), ``submit_keys`` (ingest
        lands while a window's crawl holds the lock; it re-checks its pool
        after its one suspension) and ``plane_break`` (it must reach a verb
        wedged on the plane while holding a lock) run without a lock;
        ``plane_reset`` runs under the server's (the plane is shared), every
        other verb under its collection's."""
        try:
            if verb not in self.VERBS:
                raise ValueError(f"unknown verb {verb!r}")
            if verb in ("add_keys", "submit_keys", "plane_break"):
                with guards.unguarded("unlocked fast-path verb: add_keys is event-loop-atomic; "
                                      "submit_keys re-validates after its one suspension "
                                      "(executor admission); plane_break must reach a verb "
                                      "wedged on the plane while holding its lock"):
                    return await getattr(self, verb)(req, cs)
            if verb == "plane_reset":
                async with self._verb_lock:
                    return await self.plane_reset(req, cs)
            with guards.unguarded("frame-arrival prefetch: event-loop-atomic, device work "
                                  "only, recomputed under the lock on any failure"):
                self._maybe_pre_expand(cs, verb, req)
            async with cs._verb_lock:
                if verb != "status":  # a probe is not the collection's phase
                    cs.phase, cs.level = f"verb:{verb}", (req or {}).get("level")
                try:
                    return await getattr(self, verb)(req, cs)
                finally:
                    if verb != "status":
                        cs.phase = cs.level = None
        # fhh-lint: disable=broad-except (RPC boundary: EVERY failure
        # mode must surface to the caller as an error response — a
        # narrowed list would hang the leader on the first unlisted one)
        except Exception as e:
            obs.emit("verb.error", severity="warn", server=self.server_id, verb=verb,
                     collection=cs.key, error=f"{type(e).__name__}: {e}")
            return {"__error__": f"{type(e).__name__}: {e}"}

    async def _dispatch(self, sess: _Session | None, cs, req_id, verb: str, req):
        """Run one verb at most once per (session, request id): a replay of
        a finished request is answered from the session's cache, a replay of
        one still running awaits the same execution.  Errors are responses
        too, so a rejection replays as the same rejection.  A connection
        that never said hello has no session and no dedup, and works on the
        default collection.

        The verb runs under the trace context its request carries (the
        leader's call span, JAX rpc.py:2801) and in a ``verb:{verb}`` span
        of its collection's registry, whose seconds also feed the
        ``rpc:{verb}`` histogram; ``status`` is neither (a probe is not the
        collection's phase, nor its progress)."""
        self.obs.count("verb_requests")  # the dedup rate's denominator
        if cs is None:
            with guards.unguarded("serve-loop session bind: event-loop-atomic lookup in "
                                  "the session table"):
                cs = self._default()
        cs.last_used = time.monotonic()
        if sess is not None:
            sess.last_seen = time.monotonic()
            if req_id in sess.cache:
                self.obs.count("dedup_hits")
                obs.emit("resilience.replay", severity="debug", server=self.server_id,
                         verb=verb, req_id=req_id)
                sess.cache.move_to_end(req_id)
                return sess.cache[req_id]
            live = sess.inflight.get(req_id)
            if live is not None:
                self.obs.count("dedup_hits")
                return await asyncio.shield(live)
            done = sess.inflight[req_id] = asyncio.get_running_loop().create_future()
        ttok = (obstrace.activate(req.get("trace"))
                if obstrace.enabled() and isinstance(req, dict) else None)
        t_verb = time.monotonic()
        try:
            with (contextlib.nullcontext() if verb == "status"
                  # fhh-lint: disable=span-discipline (the with-item picks a nullcontext for status; the span it otherwise names is entered and exited by this with statement)
                  else cs.obs.span(f"verb:{verb}")):
                resp = await self._run_verb(cs, verb, req)
        except asyncio.CancelledError:  # release any replay awaiting this execution
            if sess is not None:
                sess.inflight.pop(req_id, None)
                if not done.done():
                    done.cancel()
            raise
        finally:
            obstrace.deactivate(ttok)
        if verb != "status":  # a probe is not progress
            cs.obs.observe(f"rpc:{verb}", time.monotonic() - t_verb)
            cs.last_progress = time.monotonic()
            cs.obs.gauge("last_progress_ts", round(time.time(), 3))
        if sess is not None:
            sess.put(req_id, resp)
            sess.inflight.pop(req_id, None)
            if not done.done():
                done.set_result(resp)
        return resp

    def _bind_session(self, req) -> _Session | None:  # fhh-race: atomic (serve-loop session table: create-or-attach + eviction never suspends; all connections share one event loop)
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
        epoch = int((req or {}).get("epoch", 0))
        if epoch > 1:  # epoch 1 is the first connect, not a recovery
            self.obs.count("session_reconnects")
            obs.emit("resilience.session_reconnect", server=self.server_id, epoch=epoch)
        sess.last_seen = time.monotonic()
        return sess

    async def _handle_leader(self, reader, writer) -> None:
        """Control-plane serve loop: every request runs as its own task, so
        many ``add_keys`` chunks are in flight at once; responses carry the
        request id.  A ``__hello__`` binds the connection to its leader's
        session (:meth:`_dispatch`) and to the collection it names
        (``collection``; none: the default one), counted in the collection's
        ``bound`` until the connection closes; a key the table refuses (an
        invalid key, the session bound reached) answers the hello with the
        error.  On disconnect the verbs in flight finish (a verb
        mid-exchange must not leave the peer's frame unread) and their
        answers stay in the session's cache for the replay on the next
        connection."""
        write_lock = asyncio.Lock()
        self._ctl_writers.add(writer)
        sess = cs = None

        async def respond(req_id, resp):
            try:
                async with write_lock:
                    await _send(writer, (req_id, resp),
                                count=lambda n: self.obs.count("control_bytes_sent", n))
            except ConnectionError:
                pass  # leader gone; the verb itself has finished
            except RuntimeError:
                if not writer.is_closing():  # asyncio's write on a closing transport
                    raise

        async def handle(sess, cs, req_id, verb, req):
            await respond(req_id, await self._dispatch(sess, cs, req_id, verb, req))

        tasks: set = set()
        try:
            while True:
                req_id, verb, req = await _recv(
                    reader, count=lambda n: self.obs.count("control_bytes_recv", n))
                if verb == "__hello__":
                    try:
                        with guards.unguarded("serve-loop session bind: event-loop-atomic "
                                              "lookup in the session table"):
                            new_cs = self._table.get((req or {}).get("collection"))
                    except (ValueError, RuntimeError) as e:
                        await respond(req_id, {"__error__": f"{type(e).__name__}: {e}"})
                        continue
                    with guards.unguarded("serve-loop session bind: event-loop-atomic "
                                          "replay-table update"):
                        sess = self._bind_session(req)
                    if new_cs is not cs:
                        if cs is not None:
                            cs.bound -= 1
                        new_cs.bound += 1
                    cs = new_cs
                    if sess is not None:
                        sess.collection = cs.key
                    await respond(req_id, {"boot_id": self.boot_id, "server_id": self.server_id,
                                           "collection": cs.key,
                                           "clock": round(time.time(), 6)})
                    continue
                t = asyncio.create_task(handle(sess, cs, req_id, verb, req))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            # drain, don't cancel: a verb mid-exchange must not leave the
            # peer's frame unread.  Cancel only when the peer plane is gone
            # (the data plane is lost anyway) or when no task has finished
            # for DRAIN_BACKSTOP_S while the plane stays open: a wedged verb,
            # not a long one.  A silently dead peer surfaces through the data
            # plane's TCP keepalive, which ends the blocked verb.
            pending = set(tasks)
            deadline = time.monotonic() + DRAIN_BACKSTOP_S
            while pending:
                done, pending = await asyncio.wait(pending, timeout=DRAIN_POLL_S)
                if done:  # progress: push the backstop out again
                    deadline = time.monotonic() + DRAIN_BACKSTOP_S
                if pending and (self._peer_writer is None or self._peer_writer.is_closing()
                                or time.monotonic() > deadline):
                    for t in pending:
                        t.cancel()
                    break
            writer.close()
            self._ctl_writers.discard(writer)
            if cs is not None:
                cs.bound -= 1  # the connection is gone: so is its binding

    @staticmethod
    async def _recv_plane_frame(reader):
        """One data-plane frame for the mux's pump -> (framed bytes, frame)."""
        # fhh-lint: disable=unbounded-await (serve-loop read: the pump waits indefinitely for the next frame by design; liveness comes from the socket's TCP keepalive)
        (n,) = _HDR.unpack(await reader.readexactly(_HDR.size))
        # fhh-lint: disable=unbounded-await (as above)
        return n + _HDR.size, pickle.loads(await reader.readexactly(n))

    def _attach_plane(self, reader, writer) -> None:
        """Bind a new peer transport (closing the one it replaces) to the
        mux, failing every receiver of the old one; each collection re-keys
        its channel at its next data-plane verb, the coin flip and in secure
        mode fresh base-OT sessions (a survivor that kept its old OT
        extension with a restarted peer would break the 2PC)."""
        old = self._peer_writer
        if old is not None and old is not writer and not old.is_closing():
            old.close()
        self._peer_reader, self._peer_writer = reader, writer
        _keepalive(writer)
        self._plane.attach(reader, self._recv_plane_frame)

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
        with self.obs.span("setup"):
            if self.server_id == 1:
                ready = asyncio.Event()

                async def on_peer(reader, writer):
                    self._attach_plane(reader, writer)
                    ready.set()

                self._peer_srv = await asyncio.start_server(on_peer, host, peer_port)
                if on_plane_listen is not None:
                    on_plane_listen()
                # fhh-lint: disable=unbounded-await (startup barrier: a
                # listening server legitimately waits as long as it takes
                # its peer to come up; operators bound this externally)
                await ready.wait()
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
        self._plane.close()
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
    {session, epoch, collection}`` on every connect (``epoch`` counts
    connects; ``collection``, from ``collection=``, binds every connection,
    a reconnect's too, to that collection's state on the server).  A
    call keeps one request id for its life: after a transport loss it
    redials under ``dial_policy`` (one redial per epoch; calls that failed
    together ride it) and resends the same frame, which the server answers
    from its dedup cache if the verb already ran.  Two ways out besides an
    answer: the verb's budget (``budgets``) runs out (``TimeoutError``),
    or the hello finds a new boot id (:class:`ServerRestartedError`).

    Telemetry (JAX rpc.py:3240-3600): control bytes, reconnects and call
    retries count on ``obs`` (``reg``, else the process's default registry;
    a leader rebinds it to its own).  Under an active trace each call
    carries its span id in the request's ``trace`` field, minted once and
    replayed with the request id, and closes as a ``call:{verb}`` span; a
    hello's or first-attempt status's ``clock`` gives the server's clock
    offset."""

    def __init__(self, host: str, port: int, reg=None, *, dial_policy=None, budgets=None,
                 collection: str | None = None):
        self._host, self._port = host, port
        self._r = self._w = None
        self._send_lock = asyncio.Lock()
        self._conn_lock = asyncio.Lock()
        self._pending: dict = {}
        self._next_id = 0
        self._reader_task = None
        self._dead: ConnectionError | None = None
        # the collection every connection of this client binds (None: the
        # default one), named in each hello, reconnects included
        self.collection = collection or DEFAULT_COLLECTION
        self.session_id = secrets.token_hex(8)
        self.epoch = 0  # connects so far; above 1 the client has reconnected
        self.boot_id = self.server_id = None  # from the last hello
        self.dial_policy = dial_policy or respolicy.DIAL_POLICY
        self.budgets = budgets or respolicy.VerbBudgets()
        self._clock_tag = None  # "server{id}", from the hello
        self.obs = obsmetrics.default_registry() if reg is None else reg

    @classmethod
    async def connect(cls, host: str, port: int, **kw) -> "CollectorClient":
        c = cls(host, port, **kw)
        await c._ensure_connected(0)
        return c

    def _note_clock(self, resp, t_sent: float) -> None:
        """A hello's or status's ``clock``: the NTP-style midpoint offset
        (server clock - this clock) for ``obs.trace merge`` (JAX
        rpc.py:3401-3418)."""
        if not obstrace.enabled() or not isinstance(resp, dict):
            return
        clock = resp.get("clock")
        if clock is None:
            return
        sid = resp.get("server_id")
        if sid is not None:
            self._clock_tag = f"server{sid}"
        if self._clock_tag is None:
            return
        t_recv = time.time()
        obstrace.note_clock(self._clock_tag, float(clock) - (t_sent + t_recv) / 2.0,
                            t_recv - t_sent)

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
            t_hello = time.time()
            hello = await self._roundtrip(
                self._next_id, "__hello__",
                {"session": self.session_id, "epoch": self.epoch, "collection": self.collection},
                self.budgets.deadline("__hello__"))
            self._note_clock(hello, t_hello)
            if isinstance(hello, dict) and "__error__" in hello:
                raise RuntimeError(f"hello refused by {self._host}:{self._port}: "
                                   f"{hello['__error__']}")
            old_boot = self.boot_id
            self.boot_id, self.server_id = hello.get("boot_id"), hello.get("server_id")
            if self.epoch > 1:
                self.obs.count("reconnects")
                obs.emit("resilience.reconnect", host=self._host, port=self._port,
                         epoch=self.epoch,
                         restarted=bool(old_boot and old_boot != self.boot_id))

    async def _read_loop(self, reader) -> None:
        try:
            while True:
                req_id, resp = await _recv(
                    reader, count=lambda n: self.obs.count("control_bytes_recv", n))
                fut = self._pending.pop(req_id, None)
                if fut is not None and not fut.done():
                    fut.set_result(resp)
        except Exception as e:  # fhh-lint: disable=broad-except (reader death fails every call in flight with the ConnectionError; an error outside TRANSIENT_ERRORS is a bug here, emitted as client.reader_error and re-raised as the task's result)
            self._fail_pending(ConnectionError(
                f"connection to {self._host}:{self._port} lost: {e!r}"))
            if not isinstance(e, respolicy.TRANSIENT_ERRORS):
                # nothing awaits this task, so a bare re-raise would sit
                # unretrieved: emit it now, then re-raise for any consumer
                obs.emit("client.reader_error", severity="error",
                         error=f"{type(e).__name__}: {e}")
                raise

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
                            count=lambda n: self.obs.count("control_bytes_sent", n))
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
        # under a trace, the call's span id rides the request once, and every
        # replay resends it with the request id; the request is copied, since
        # a leader sends one dict to both servers and each call owns its span
        twire = obstrace.wire_ctx() if obstrace.enabled() else None
        if twire is not None:
            req = dict(req or {}, trace=twire[0])
        self._next_id += 1
        req_id = self._next_id  # one id for the call's life: the server dedups replays
        retried = False
        try:
            while True:
                seen_epoch = self.epoch
                try:
                    t_sent = time.time()
                    resp = await self._roundtrip(req_id, verb, req, deadline)
                    if verb == "status" and not retried:
                        # a replayed status may come from the dedup cache,
                        # whose clock is the first execution's
                        self._note_clock(resp, t_sent)
                    break
                except respolicy.TRANSIENT_ERRORS as e:
                    retried = True
                    if deadline.expired():
                        raise TimeoutError(f"verb {verb!r} exceeded its "
                                           f"{self.budgets.budget(verb):g}s budget (last "
                                           f"error: {type(e).__name__}: {e})") from e
                    self.obs.count("call_retries")
                    obs.emit("resilience.call_retry", severity="debug", verb=verb,
                             epoch=seen_epoch, error=f"{type(e).__name__}: {e}")
                    await self._ensure_connected(seen_epoch)
                    if first_boot is not None and self.boot_id != first_boot:
                        raise ServerRestartedError(
                            f"server {self._host}:{self._port} restarted while {verb!r} was "
                            "in flight — state lost, replay unsafe") from e
        except BaseException:
            if twire is not None:
                obstrace.call_event(verb, self.obs.name, twire[1], error=True)
            raise
        server_err = isinstance(resp, dict) and "__error__" in resp
        if twire is not None:
            obstrace.call_event(verb, self.obs.name, twire[1], error=server_err)
        if server_err:
            raise RuntimeError(f"server error on {verb}: {resp['__error__']}")
        return resp

    async def aclose(self) -> None:
        self._dead = ConnectionError("client closed")
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._w is not None and not self._w.is_closing():
            self._w.close()
        self._fail_pending(self._dead)
