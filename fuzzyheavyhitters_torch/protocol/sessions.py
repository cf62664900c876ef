"""Per-collection sessions: the multi-tenant half of the socket server (the
port of ``fuzzyheavyhitters_tpu/protocol/sessions.py``).

The protocol is independent across collections (independent trees, keys
and 2PC transcripts), so one server pair serves many collections at once
once every piece of per-collection state is keyed:

- :class:`CollectionSession`: everything one collection's crawl owns: the
  uploaded key chunks and the key batch, the frontier and child caches, the
  mask cache, the sketch state and its ratchet, a loaded window's root, the
  OT sender and receiver, the secure seeds, the coin flip and the plane
  epoch it was keyed at, the data shards' ``ServerMesh``, the ingest pools
  and their admission gate, the checkpoint namespace, the per-collection
  counters and the verb lock its verbs serialize on.
- :class:`SessionTable`: the bounded table of live sessions, selected on
  the wire by the ``collection`` field of ``__hello__`` (a connection that
  names none works on the default collection, so every single-tenant flow
  is unchanged).  Past ``Config.collection_sessions_max`` an idle session
  is evicted oldest first; a session with state or live bindings never is.
- :class:`PlaneMux`: the server↔server socket demultiplexed into one FIFO
  channel a collection.  Every data-plane frame is ``(collection,
  payload)``; one pump routes the frames into per-channel queues, so two
  collections' exchanges share the socket without ordering assumptions.

Checkpoint names: the default collection keeps ``fhh_server{id}_l{level}
.npz``; any other collection writes ``fhh_server{id}_c{key}_l{level}.npz``,
and every blob is stamped with its collection (``sess``), so a blob renamed
across namespaces is refused at restore.

The trusted exchange's shared mask stream lives here too: server 0 answers
``count + r`` and server 1 answers ``r``, with ``r`` drawn from one stream
both derive from a public seed (server.rs:331-332), so the leader's ``v0 -
v1`` reconstruction is the same as in secure mode.  A wire-format shim, not
a secret.  Host NumPy on purpose: the rows are tiny (F · 2^d elements a
level).
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import re
import secrets
import time

import numpy as np
import torch

from .. import native
from ..ops import dpf, ibdcf, prg
from ..ops.fields import F255, FE62
from ..parallel import server_mesh as smesh
from ..parallel import sketch_shard
from ..resilience import admission
from ..utils import tensor_from_numpy, words_from_numpy, words_to_numpy
from . import collect
from . import sketch as sketchmod

DEFAULT_COLLECTION = "default"
# collection keys name checkpoint files and wire channels: keep them
# filesystem- and log-safe
_KEY_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
SHARED_MASK_SEED = b"XXX This is bog\x00"  # 16 B, ref: server.rs:331-332


def check_key(key: str | None) -> str:
    """The collection a key names ("" and None: the default one); raises
    the JAX table's ``ValueError`` for a key that cannot name a file or a
    channel."""
    key = key or DEFAULT_COLLECTION
    if not _KEY_RE.match(key):
        raise ValueError(
            f"collection key {key!r} is invalid (want "
            "[A-Za-z0-9._-]{1,64}: it names checkpoint files and "
            "wire channels)"
        )
    return key


def _mask_words(level: int, n: int, blocks_for: int) -> np.ndarray:
    """uint32[n, blocks_for]: the level's mask words (seed word 3 ^= level)."""
    seed = prg.seeds_from_bytes(SHARED_MASK_SEED)[0].copy()
    seed[3] ^= np.uint32(level)
    return prg.np_stream_words(seed, n * blocks_for).reshape(n, blocks_for)


def mask_fe62(level: int, n: int) -> np.ndarray:
    """uint64[n] FE62 mask values of one level."""
    return FE62.np_sample(_mask_words(level, n, 4))


def mask_f255(level: int, n: int) -> np.ndarray:
    """uint32[n, 8] F255 mask values of one level."""
    return F255.np_sample(_mask_words(level, n, 8))


def mask_rows(level: int, F: int, C: int, f255: bool) -> np.ndarray:
    """One whole level's mask rows: ``[F, C]`` FE62 or ``[F, C, 8]`` F255
    (the JAX ``CollectionSession.mask_rows`` without node-span shards)."""
    if f255:
        return mask_f255(level, F * C).reshape(F, C, 8)
    return mask_fe62(level, F * C).reshape(F, C)


class _WindowPool:
    """One ingest window's append-only key pool (the streaming front
    door's unit of work: protocol verbs ``submit_keys`` → ``window_seal``
    → ``window_load``).

    ``entries`` holds admitted submissions (tuples of key arrays, the
    same chunk shape ``add_keys`` receives) in arrival order; once the
    reservoir shed policy engages, the list freezes into a SLOT TABLE
    and replacements overwrite in place.  ``verdicts`` records every
    FINAL outcome by ``sub_id`` so at-least-once delivery (reconnect
    replays, recovery journal replays) answers the recorded verdict
    instead of double-admitting or re-advancing the sampler's RNG.
    Overloaded rejections are deliberately NOT recorded — a backed-off
    retry is a fresh attempt against refilled tokens."""

    __slots__ = (
        "window", "wa", "entries", "verdicts", "keys",
        "admitted_keys", "shed_keys", "rejected", "sealed", "sealed_at",
        "sk_root",
    )

    def __init__(self, window: int, wa: admission.WindowAdmission):
        self.window = int(window)
        self.wa = wa
        self.entries: list = []
        self.verdicts: dict = {}
        self.keys = 0
        self.admitted_keys = 0
        self.shed_keys = 0
        self.rejected = 0
        self.sealed = False
        # wall-clock seal instant: the start of this window's
        # seal-to-hitters SLO clock (observed at final_shares of the
        # crawl that loads the window — protocol/rpc.py)
        self.sealed_at: float | None = None
        # malicious mode: the window's committed sketch-challenge root
        # (uint32[4], sketch.window_root) — stamped at seal, carried by
        # the seal stats and the ingest checkpoint so a recovered
        # window's crawl replays the IDENTICAL challenge sequence
        self.sk_root: np.ndarray | None = None

    def apply(self, sub_id: str, chunk: tuple,
              v: admission.Verdict) -> dict:
        """Commit one gate verdict to the pool; returns the wire
        response (the mirror server replays it via :meth:`apply_mirror`)."""
        n_keys = int(chunk[0].shape[0])
        if not v.admitted and v.scope is not None:
            self.rejected += 1
            return {
                "admitted": False, "overloaded": True, "scope": v.scope,
                "retry_after_s": round(float(v.retry_after_s), 4),
                "window": self.window,
            }
        if not v.admitted:  # reservoir shed this submission
            resp = {"admitted": False, "shed": True, "window": self.window}
            self.verdicts[sub_id] = resp
            self.shed_keys += n_keys
            return resp
        if v.slot is None:
            self.entries.append(chunk)
            self.keys += n_keys
        else:
            old = self.entries[v.slot]
            old_n = int(old[0].shape[0])
            self.entries[v.slot] = chunk
            self.keys += n_keys - old_n
            self.shed_keys += old_n
            # keep the admission ledger's occupancy honest under
            # variable-size chunks
            self.wa.keys += n_keys - old_n
        self.admitted_keys += n_keys
        resp = {"admitted": True, "slot": v.slot, "window": self.window}
        self.verdicts[sub_id] = resp
        return resp

    def apply_mirror(self, sub_id: str, chunk: tuple, mirror: dict,
                     client_id: str | None = None) -> dict:
        """Replay the GATE server's verdict on the peer pool so both
        servers' windows stay positionally identical.  Validates loudly —
        a mirror that cannot apply means the two pools diverged, which
        must never be papered over."""
        n_keys = int(chunk[0].shape[0])
        slot = mirror.get("slot")
        if self.wa.shed == admission.SHED_RESERVOIR:
            if self.wa.sub_keys is None:
                self.wa.sub_keys = n_keys  # uniform-chunk contract holds
            if mirror.get("shed") or slot is not None:
                # a restored GATE being rebuilt by the recovery journal:
                # the replayed verdict consumed one sampler draw in its
                # first life — advance the restored stream past it (the
                # verdict itself is applied verbatim below), so
                # post-recovery live admissions continue the SAME
                # seed-reproducible sequence.  When the reservoir
                # engaged only AFTER the last checkpoint, there is no
                # sampler to advance yet: bank the draw so the eventual
                # engagement fast-forwards past it.  A mirror server
                # never re-engages a reservoir, so this is harmless
                # bookkeeping outside recovery.
                if self.wa.reservoir is not None:
                    self.wa.reservoir.offer(1)
                else:
                    self.wa.pending_draws += 1
        if mirror.get("shed"):
            resp = {"admitted": False, "shed": True, "window": self.window}
            self.verdicts[sub_id] = resp
            self.shed_keys += n_keys
            return resp
        if slot is None:
            if self.keys + n_keys > self.wa.max_keys:
                raise RuntimeError(
                    f"ingest mirror overflows window {self.window}: "
                    f"{self.keys} + {n_keys} > {self.wa.max_keys} "
                    "(gate/mirror pools diverged)"
                )
            self.entries.append(chunk)
            self.keys += n_keys
            # keep the admission ledger in lockstep: a recovery journal
            # replay rebuilds a restarted GATE through this path, and its
            # later live decisions must see the true occupancy
            self.wa.subs += 1
            self.wa.keys += n_keys
            self.wa._charge(client_id, n_keys)
        else:
            slot = int(slot)
            if not 0 <= slot < len(self.entries):
                raise RuntimeError(
                    f"ingest mirror names slot {slot} of a "
                    f"{len(self.entries)}-slot window {self.window} pool "
                    "(gate/mirror pools diverged)"
                )
            old_n = int(self.entries[slot][0].shape[0])
            self.entries[slot] = chunk
            self.keys += n_keys - old_n
            self.shed_keys += old_n
            self.wa.keys += n_keys - old_n
            self.wa._charge(client_id, n_keys)
        self.admitted_keys += n_keys
        resp = {"admitted": True, "slot": slot, "window": self.window}
        self.verdicts[sub_id] = resp
        return resp

    def stats(self) -> dict:
        out = {
            "window": self.window,
            "sealed": self.sealed,
            "keys": self.keys,
            "subs": len(self.entries),
            "admitted_keys": self.admitted_keys,
            "shed_keys": self.shed_keys,
            "rejected": self.rejected,
        }
        if self.sk_root is not None:
            # plain ints: the leader banks these stats and replays them
            # into a recovery re-seal (dict equality in tests must stay
            # unambiguous, so no ndarray values here)
            out["sk_root"] = [int(x) for x in self.sk_root]
        return out


# the per-collection counters (the server's own ``stats`` holds their totals
# and the shared plane's: control bytes, dedup hits, plane resets, the
# largest data-plane frame): crawl verbs begun and finished, add_keys
# chunks, checkpoints written (bytes, seconds) and restored (seconds),
# sketch_verify verbs and the prunes' sketch advance seconds, device
# readbacks, the data shards' reductions, gathers, faults, re-shards and
# re-runs, the ingest front door's submissions (replays among them),
# admitted and shed keys, Overloaded answers and sealed windows, the
# data-plane bytes, the warmup's shapes and warm-ladder hits, the
# channel's handshakes (the coin flip and, secure, the base OT) and their
# seconds, and the fleet's session exports, imports and retirements
SESSION_COUNTERS = ("levels", "levels_done", "add_keys", "ckpt_writes", "ckpt_bytes",
                    "ckpt_write_s", "restores", "restore_s", "sketch_verifies",
                    "sketch_advance_s", "device_fetches", "ici_reduce_s", "kernel_gathers",
                    "kernel_gather_s", "mesh_faults", "mesh_reshards", "shards_rerun",
                    "pool_submits", "pool_dup_submits", "pool_admitted_keys", "pool_shed_keys",
                    "pool_rejected", "windows_sealed", "data_bytes_sent", "data_bytes_recv",
                    "warmup_shapes", "warmup_ladder_hits", "plane_handshakes",
                    "plane_handshake_s", "session_exports", "session_imports",
                    "sessions_retired")
# the run report's phases: host-clock spans of every level (the JAX server's
# fss, gc_ot, field), then the secure exchange's steps, spans of the device
# stream on the card (driver.PhaseClock), then the sketch_verify verbs' host
# seconds (the JAX server's "sketch" span)
PHASES = ("fss", "gc_ot", "field", "otext", "b2a", "garble", "eval", "sketch")


def new_stats() -> dict:
    """Zeroed counters, the phases' seconds and the last window's seconds
    from its seal to its final shares (None before one)."""
    return {"seconds": dict.fromkeys(PHASES, 0.0), **dict.fromkeys(SESSION_COUNTERS, 0),
            "seal_to_hitters_s": None}


class CollectionSession:
    """One collection's whole server-side state (see the module doc).  The
    server's verbs receive the session bound by their connection's
    ``__hello__`` and serialize on its ``_verb_lock``, so two collections'
    verbs interleave on the event loop while each collection's own verbs
    stay ordered.  ``bound`` counts the connections bound to it (a bound
    session is never evicted); ``last_used`` marks a verb's arrival and
    ``last_progress`` its completion; ``phase``/``level`` name the verb
    running (None between verbs)."""

    # verdict codes in the checkpoint blob: slot >= 0, -1 = appended in
    # arrival order (no slot), -2 = reservoir-shed
    _ING_APPEND, _ING_SHED = -1, -2

    def __init__(self, key: str, server_id: int, cfg, device, ckpt_dir: str | None):
        self.key = key
        self.server_id = server_id
        self.cfg = cfg
        self.device = device
        self.ckpt_dir = ckpt_dir
        self.last_used = self.last_progress = time.monotonic()
        self.bound = 0
        self.phase = self.level = None
        self.stats = new_stats()
        # the plane epoch this session's channel was keyed against (the coin
        # flip, and in secure mode its base-OT sessions); 0: never
        self.plane_epoch = 0
        self._ot_snd = self._ot_rcv = None  # extension sender (garbler) / receiver
        self._sec_seed = None  # per-level GC and b2a seeds
        self._crawl_ctr = 0
        self._sketch_seed = None  # this channel's coin flip: uint32[4]
        # data shards (JAX sessions.py:403): bound to this collection's batch
        k = smesh.resolve_data_devices(cfg.server_data_devices, device)
        self._mesh = smesh.ServerMesh(k, device) if k > 1 else None
        # the last value of the data shards' per-level gauges (None before
        # any), and the kernel stage's widest
        self._gauges = {"kernel_shards": None, "kernel_shards_max": None,
                        "sketch_shards": None}
        # the streaming front door: window pools and a gate of its own, so a
        # flooding tenant drains only its own token bucket; the gate's
        # arithmetic runs in an executor behind ``_adm_gate``
        self._ingest_pools: dict = {}
        self._admission = admission.AdmissionController(
            max_window_keys=cfg.ingest_window_keys,
            rate_keys_per_s=cfg.ingest_rate_keys_per_s,
            burst_keys=cfg.ingest_burst_keys,
            client_quota=cfg.ingest_client_quota,
            shed=cfg.ingest_shed,
            seed=cfg.ingest_seed,
        )
        self._adm_gate = asyncio.Lock()
        self._verb_lock = asyncio.Lock()
        # the fleet's migration stamps (JAX sessions.py:391-396): each export
        # blob carries (boot id, export epoch), and an import refuses a stamp
        # it took already (applied twice, a transfer lands its in-flight
        # submissions twice)
        self._export_epoch = 0
        self._import_seen: set = set()
        self.clear()

    # -- lifecycle --------------------------------------------------------

    def clear(self) -> None:
        """Drop the crawl and sketch state (``window_load``'s fresh batch);
        the ingest pools and checkpoints stay."""
        # the uploaded numpy key chunks; with data shards they are kept after
        # concatenation, for a re-shard after a device loss rebuilds the keys
        # from them
        self.keys_parts: list = []
        self._keys_stale = False  # chunks arrived since the keys were built
        # IbDcfKeyBatch [N, d, 2] on the device; with data shards one per
        # shard, and so for the frontier and the child cache
        self.keys = None
        self.alive_keys = None
        self.frontier = None
        self.children = None  # the child cache of this level's crawl
        self.last_shares = None  # surviving leaves' F255 shares
        self.clear_spans()
        # the malicious sketch (JAX sessions.py:351-369): uploaded chunks, the
        # key batch on the device, the frontier-following DPF states [F, N,
        # d], the dedup table of each slot's per-dim prefix int32[F, d], the
        # depth they stand at, the stored pair shares awaiting the next
        # sketch_verify ([(pairs, depth, field)], one a fused bit level), the
        # ratchet's committed root and its transcript digest
        self._sketch_parts: list = []
        self._sketch = None
        self._sketch_states = None
        self._sketch_pids = None
        self._sketch_depth = 0
        self._sketch_pairs = None
        self._sketch_root = None
        self._ratchet_digest = None
        # a loaded window's committed challenge root, which tree_init takes
        # in place of the coin flip, and its seal instant (None: a bulk upload)
        self._window_sketch_root = None
        self._window_seal_ts = None

    def clear_spans(self) -> None:
        self._shard_children: dict = {}  # span lo -> child cache of this level
        self._shard_last: dict = {}  # span lo -> last-level shares
        self._shard_level = None
        self._expand_ready: dict = {}  # (last, level, span) -> pre-expanded stage
        self._mask_cache = None  # ((level, F, f255), the whole level's mask rows)

    def reset_state(self) -> None:
        """The ``reset`` verb's body: a new collection run opens clean (crawl
        and sketch state, ingest pools, checkpoint namespace), with fresh
        GC/b2a randomness when the secure plane is keyed."""
        self.clear()
        self._ingest_pools.clear()
        self.ckpt_clear()
        if self._ot_snd is not None:
            self._sec_seed = np.frombuffer(secrets.token_bytes(16), "<u4").copy()

    def idle(self) -> bool:
        """Nothing durable here and no connection bound: an eviction
        candidate."""
        return (self.bound == 0 and self.keys is None and not self.keys_parts
                and self.frontier is None and not self._ingest_pools
                and not self._verb_lock.locked())

    # -- the key batch and data shards: one code path, a list of one part
    # without shards ------------------------------------------------------

    def _shards(self, x) -> list:
        """The per-shard parts of ``x`` (keys, a frontier, a child cache)."""
        return x if self._mesh is not None else [x]

    def _one(self, parts: list):
        """:meth:`_shards`' inverse."""
        return parts if self._mesh is not None else parts[0]

    def _kb(self) -> ibdcf.IbDcfKeyBatch:
        """A key batch to read the key shapes from (the first shard's)."""
        return self._shards(self.keys)[0]

    def _n_clients(self) -> int:
        return self._mesh.n_clients if self._mesh is not None else self.keys.cw_seed.shape[0]

    def _data_len(self) -> int:
        return self._kb().cw_seed.shape[-2]

    def _f_bucket(self) -> int:
        return self._shards(self.frontier)[0].f_bucket

    def _gauge(self, name: str, value: int) -> None:
        self._gauges[name] = value
        if name == "kernel_shards":
            self._gauges["kernel_shards_max"] = max(self._gauges["kernel_shards_max"] or 0,
                                                    value)

    def _has_sketch(self) -> bool:
        return bool(self._sketch_parts) or self._sketch is not None

    def _concat_sketch(self) -> None:
        """The uploaded sketch chunks as one key batch on the device."""
        if self._sketch_parts:
            leaves = [np.concatenate(p) for p in zip(*self._sketch_parts)]
            self._sketch_parts = []
            self._sketch = sketchmod.sketch_from_numpy(leaves, self.device)

    def _concat_keys(self, verb: str) -> None:
        """The uploaded chunks as one key batch on the device (with data
        shards, bound to the batch and split per shard), checked against
        the crawl radix.  With data shards the chunks are kept."""
        if not self.keys_parts and self.keys is None:
            raise RuntimeError(f"{verb} before add_keys")
        if self.keys is None or self._keys_stale:
            leaves = [np.concatenate(p) for p in zip(*self.keys_parts)]
            if self._mesh is not None:
                self._mesh.bind(leaves[0].shape[0])
                self.keys = self._mesh.shard_keys(leaves)
            else:
                self.keys_parts = []  # only a re-shard reads them again
                self.keys = ibdcf.keys_from_numpy(ibdcf.IbDcfKeyBatch(*leaves), self.device)
            self._keys_stale = False
        d = self._kb().cw_seed.shape[1]
        if not 1 <= d <= collect.MAX_DIMS:
            raise ValueError(f"n_dims={d}: supported 1..{collect.MAX_DIMS}")
        collect.check_radix(d, self.cfg.crawl_radix_bits)

    def _keys_fp(self) -> np.ndarray:
        """uint8[32]: SHA-256 over ``key_idx`` then ``root_seed`` in their
        wire dtypes, byte for byte the JAX session's ``keys_fp``: did the
        leader re-upload the batch this checkpoint was written under (an
        operational check, not a cryptographic one)."""
        keys = self._shards(self.keys)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(np.concatenate([k.key_idx.cpu().numpy() for k in keys])))
        h.update(np.ascontiguousarray(np.concatenate([words_to_numpy(k.root_seed)
                                                      for k in keys])))
        return np.frombuffer(h.digest(), np.uint8)

    def crawl_radix(self, level: int) -> int:
        """Bit levels of the crawl round based at ``level``: the collection's
        radix, clipped at the tail of the key batch's data_len."""
        return min(self.cfg.crawl_radix_bits, self._data_len() - int(level))

    # -- the malicious sketch ---------------------------------------------

    def challenge_seed(self, level: int) -> np.ndarray:
        """This level's sketch challenge: the ratchet of the committed root,
        the level and the transcript digest (the channel's raw coin flip only
        before any ``tree_init`` committed a root)."""
        if self._sketch_root is None:
            return self._sketch_seed
        return sketchmod.ratchet_seed(self._sketch_root, level, self._ratchet_digest)

    def advance_sketch(self, level: int, parent: np.ndarray, pat: np.ndarray,
                       n_alive: int) -> None:
        """Advance the frontier-following sketch states with the prune's
        survivor table (dim j's direction is pattern bit j), r steps for a
        fused ``pat`` [F', r, d], storing each new depth's pair shares gated
        by per-dim prefix dedup: two frontier slots that share a dim-j
        prefix are one node of dim j's 1-D sketch tree and count once (the
        first slot keeps it).  The dedup table comes from the public
        survivor table, so both servers gate alike (JAX sessions.py:552-628)."""
        L = self._data_len()
        k = self._sketch.key  # batch [N, d]
        d = k.root_seed.shape[1]
        r = pat.shape[1]
        par = torch.from_numpy(np.asarray(parent, np.int64)).to(self.device)
        st = dpf.DpfEvalState(seed=self._sketch_states.seed[par], t=self._sketch_states.t[par])
        F2 = parent.shape[0]
        parent_pid = self._sketch_pids[parent[:n_alive]]  # [n_alive, d]
        pids = self._sketch_pids
        entries = []
        for t in range(r):
            bl = level + t  # this step's absolute bit level
            last = bl == L - 1
            fld = F255 if last else FE62
            direction = torch.from_numpy(np.ascontiguousarray(pat[:, t, :])).to(
                self.device)[:, None, :]
            cw = tuple(a[None] for a in dpf.level_cw(k, bl))  # [1, N, d, ...]
            cwv = (k.cw_val[..., bl, :] if not last else k.cw_val_last)[None]
            st, pair = dpf.eval_bit(cw, st, direction, cwv, k.key_idx[None], fld,
                                    sketchmod.LANES)  # pair [F2, N, d, LANES(, limbs)]
            # this depth's dedup key: the parent's prefix id and the step
            # bits through step t
            pids = np.zeros((F2, d), np.int32)
            keep = np.zeros((F2, d), bool)
            for j in range(d):
                key_j = np.stack([parent_pid[:, j]] + [pat[:n_alive, u, j].astype(np.int32)
                                                       for u in range(t + 1)], 1)
                _, inv = np.unique(key_j, axis=0, return_inverse=True)
                inv = inv.reshape(-1)
                pids[:n_alive, j] = inv
                _, first = np.unique(inv, return_index=True)
                keep[first, j] = True
            gate = torch.from_numpy(keep.reshape((F2, 1, d) + (1,) * (pair.dim() - 3))).to(
                self.device)
            entries.append((torch.where(gate, pair, 0), bl + 1, fld))
        self._sketch_states = st
        self._sketch_pids = pids  # the final depth's table seeds the next prune
        self._sketch_depth = level + r
        self._sketch_pairs = entries

    def _sketch_bind(self, n: int, d: int):
        """The sketch check's shard binding: the data shards under the
        ``Config.sketch_shards`` budget (0 follows the data shards); None
        without data shards or when one shard fits."""
        if self._mesh is None:
            return None
        budget = (self._mesh.shards if self.cfg.sketch_shards <= 0
                  else min(int(self.cfg.sketch_shards), self._mesh.shards))
        return sketch_shard.bind(self._mesh._active_devices(), n, d, budget)

    def _sketch_blob(self) -> dict:
        """The sketch's share of a checkpoint (JAX rpc.py:2092-2128): the
        frontier-following DPF states, the stored pairs not yet opened (one
        ``sk_pairs_{i}`` a fused depth, with their depths and fields), the
        dedup table, the depth, the committed root and the transcript digest
        — all a re-run needs to replay each level's challenge."""
        st = self._sketch_states
        blob = {"sk_state_seed": words_to_numpy(st.seed), "sk_state_t": st.t.cpu().numpy(),
                "sk_pids": np.asarray(self._sketch_pids), "sk_depth": np.int64(self._sketch_depth),
                "sk_root": np.asarray(self._sketch_root, np.uint32),
                "sk_digest": np.frombuffer(self._ratchet_digest, np.uint8)}
        if self._sketch_pairs is not None:
            for i, (p, _, _) in enumerate(self._sketch_pairs):
                blob[f"sk_pairs_{i}"] = sketchmod.wire(p)
            blob["sk_pairs_depth"] = np.asarray([dep for _, dep, _ in self._sketch_pairs],
                                                np.int64)
            blob["sk_pairs_last"] = np.asarray([f is F255 for _, _, f in self._sketch_pairs],
                                               bool)
        return blob

    def _check_sketch_blob(self, z: dict, path: str) -> None:
        """Refuse a blob whose sketch presence differs from the session's,
        or whose ``sk_*`` fields are torn, before any state changes (JAX
        rpc.py:2265-2284; the per-depth ``sk_pairs_{i}`` are held to their
        count as well)."""
        has = self._has_sketch()
        if has != ("sk_root" in z):
            raise RuntimeError("tree_restore: sketch material mismatch — the checkpoint "
                               + ("lacks" if has else "carries")
                               + " sketch state relative to the uploaded keys")
        if not has:
            return
        need = {"sk_state_seed", "sk_state_t", "sk_pids", "sk_depth", "sk_digest"}
        if "sk_pairs" in z or "sk_pairs_0" in z:
            need |= {"sk_pairs_depth", "sk_pairs_last"}
        if "sk_pairs_0" in z and "sk_pairs_depth" in z:
            need |= {f"sk_pairs_{i}" for i in range(np.atleast_1d(z["sk_pairs_depth"]).size)}
        missing = need - set(z)
        if missing:
            raise RuntimeError(f"tree_restore: checkpoint at {path} is missing sketch fields "
                               f"{sorted(missing)} (truncated write?)")

    def _restore_sketch(self, z: dict) -> None:
        """Load the sketch state of a checked blob: per-depth ``sk_pairs_{i}``
        entries, or the older single ``sk_pairs``."""
        self._concat_sketch()
        dev = self.device
        self._sketch_states = dpf.DpfEvalState(seed=words_from_numpy(z["sk_state_seed"], dev),
                                               t=tensor_from_numpy(z["sk_state_t"], dev, bool))
        self._sketch_pids = np.asarray(z["sk_pids"])
        self._sketch_depth = int(z["sk_depth"])
        self._sketch_root = np.asarray(z["sk_root"], np.uint32).copy()
        self._ratchet_digest = np.asarray(z["sk_digest"], np.uint8).tobytes()
        field = lambda last: F255 if bool(last) else FE62
        if "sk_pairs_0" in z:
            depths = np.atleast_1d(z["sk_pairs_depth"])
            lasts = np.atleast_1d(z["sk_pairs_last"])
            self._sketch_pairs = [(sketchmod.from_wire(z[f"sk_pairs_{i}"], dev), int(depths[i]),
                                   field(lasts[i])) for i in range(len(depths))]
        elif "sk_pairs" in z:
            self._sketch_pairs = [(sketchmod.from_wire(z["sk_pairs"], dev),
                                   int(z["sk_pairs_depth"]), field(z["sk_pairs_last"]))]
        else:
            self._sketch_pairs = None

    # -- node spans -------------------------------------------------------

    def _frontier_view(self, shard):
        if shard is None:
            return self.frontier
        return self._one([collect.frontier_slice(f, *shard) for f in self._shards(self.frontier)])

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
        items = list(self._shard_children.items())
        n = len(self._shards(self.frontier))
        children = self._one([collect.children_cat([(lo, self._shards(c)[j]) for lo, c in items])
                              for j in range(n)])
        got = self._shards(children)[0].seed.shape[4] >> (radix - 1)
        if got != self._f_bucket():
            raise RuntimeError(f"sharded crawl incomplete: child caches cover {got} of "
                               f"{self._f_bucket()} frontier slots")
        self._shard_children.clear()
        return children

    def _mask_rows(self, level: int, shard, C: int, f255: bool) -> np.ndarray:
        """The trusted answer's mask rows of one (level, span): the whole
        level's stream sliced to the span's nodes (one-entry cache)."""
        F = self._f_bucket()
        key = (level, F, f255)
        if self._mask_cache is None or self._mask_cache[0] != key:
            self._mask_cache = (key, mask_rows(level, F, C, f255))
        full = self._mask_cache[1]
        return full if shard is None else full[shard[0]:shard[1]]

    def mesh_status(self) -> dict | None:
        """The data shards in the JAX server's ``mesh`` section (None
        without them): devices in the budget, shards bound and clients per
        shard, the per-shard reductions' seconds, device faults and
        re-shards, the secure kernel stage's last and widest shard count
        (None before a secure level), the levels that gathered their share
        bits and the seconds of those gathers, and the last sketch check's
        shard count (None before one)."""
        if self._mesh is None:
            return None
        st = self.stats
        return {"data_devices": self._mesh.n_devices, "data_shards": self._mesh.shards,
                "shard_clients": self._mesh.occupancy(),
                "ici_reduce_seconds": round(st["ici_reduce_s"], 6),
                "reshards": st["mesh_reshards"], "faults": st["mesh_faults"],
                "kernel_shards": self._gauges["kernel_shards"],
                "kernel_shards_max": self._gauges["kernel_shards_max"],
                "kernel_gathers": st["kernel_gathers"],
                "kernel_gather_seconds": round(st["kernel_gather_s"], 6),
                "sketch_shards": self._gauges["sketch_shards"]}

    # -- the checkpoint namespace (JAX sessions.py:700-753) ---------------

    def ckpt_prefix(self) -> str:
        """The default collection keeps the legacy name, so single-tenant
        deployments and their checkpoints on disk are untouched; every other
        collection gets a namespace of its own."""
        if self.key == DEFAULT_COLLECTION:
            return f"fhh_server{self.server_id}_l"
        return f"fhh_server{self.server_id}_c{self.key}_l"

    def ckpt_path(self, level: int) -> str:
        # level-stamped: a torn round (one server wrote level k, the other
        # died first) leaves both able to restore the same earlier level
        return os.path.join(self.ckpt_dir, f"{self.ckpt_prefix()}{level}.npz")

    def _ckpt_found(self) -> list:
        """[(level, file name)] of this collection's checkpoints, in numeric
        level order (a string sort puts l10 before l9)."""
        if self.ckpt_dir is None or not os.path.isdir(self.ckpt_dir):
            return []
        prefix, found = self.ckpt_prefix(), []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith(prefix) and name.endswith(".npz"):
                try:
                    found.append((int(name[len(prefix):-4]), name))
                except ValueError:
                    continue
        return sorted(found)

    def ckpt_levels(self) -> list:
        return [lvl for lvl, _ in self._ckpt_found()]

    def ckpt_prune(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` checkpoint levels of this
        collection's namespace (``keep`` 0: all of them); other
        collections' files are untouched."""
        found = self._ckpt_found()
        for _, name in found[:len(found) - keep] if keep else found:
            os.remove(os.path.join(self.ckpt_dir, name))

    def ckpt_clear(self) -> None:
        self.ckpt_prune(keep=0)

    # -- the ingest pools (a gate a session) ------------------------------

    def ingest_pool(self, window: int) -> _WindowPool:
        """Create-or-get the pool for ``window``; live-window count is
        BOUNDED (``cfg.ingest_windows_retained``) so a runaway window id
        can never grow server memory — the refusal is loud, never a
        silent drop."""
        pool = self._ingest_pools.get(window)
        if pool is None:
            if len(self._ingest_pools) >= max(
                1, self.cfg.ingest_windows_retained
            ):
                # sealed EMPTY windows are fully consumed (window_load
                # skips them, so only loads drop pools): evict the
                # oldest such before refusing — a quiet stretch of idle
                # windows must not wedge the front door
                idle = [
                    w for w in sorted(self._ingest_pools)
                    if self._ingest_pools[w].sealed
                    and not self._ingest_pools[w].entries
                ]
                if idle:
                    del self._ingest_pools[idle[0]]
            if len(self._ingest_pools) >= max(
                1, self.cfg.ingest_windows_retained
            ):
                raise RuntimeError(
                    f"ingest window {window} would exceed the "
                    f"{self.cfg.ingest_windows_retained} live-window bound "
                    f"(live: {sorted(self._ingest_pools)})"
                )
            pool = self._ingest_pools[window] = _WindowPool(
                window, self._admission.window(window)
            )
        return pool

    def ingest_status(self) -> dict:
        """Front-door health for ``status``: per-window occupancy, the
        unsealed-queue depth, and the admit/shed/reject counters."""
        pools = [self._ingest_pools[w] for w in sorted(self._ingest_pools)]
        unsealed = [p for p in pools if not p.sealed]
        return {
            "current_window": (
                unsealed[-1].window if unsealed
                else (pools[-1].window if pools else None)
            ),
            "queue_depth": sum(p.keys for p in unsealed),
            "admitted": sum(p.admitted_keys for p in pools),
            "shed": sum(p.shed_keys for p in pools),
            "rejected": sum(p.rejected for p in pools),
            "windows": {
                str(p.window): {
                    "keys": p.keys,
                    "subs": len(p.entries),
                    "sealed": p.sealed,
                }
                for p in pools
            },
        }

    def ingest_ckpt_fields(self, blob: dict) -> None:
        """Flatten every live ingest pool into ``ing_*`` npz fields."""
        ws = sorted(self._ingest_pools)
        if not ws:
            return
        blob["ing_windows"] = np.asarray(ws, np.int64)
        for i, w in enumerate(ws):
            p = self._ingest_pools[w]
            blob[f"ing{i}_meta"] = np.array(
                [w, int(p.sealed), p.keys, p.admitted_keys, p.shed_keys,
                 p.rejected, len(p.entries), p.wa.subs, p.wa.keys,
                 -1 if p.wa.sub_keys is None else p.wa.sub_keys,
                 p.wa.pending_draws],
                np.int64,
            )
            sub_ids, codes = [], []
            for sid, resp in p.verdicts.items():
                sub_ids.append(sid)
                if resp.get("shed"):
                    codes.append(self._ING_SHED)
                elif resp.get("slot") is None:
                    codes.append(self._ING_APPEND)
                else:
                    codes.append(int(resp["slot"]))
            blob[f"ing{i}_sub_ids"] = np.array(sub_ids, dtype=str)
            blob[f"ing{i}_sub_codes"] = np.array(codes, np.int64)
            blob[f"ing{i}_lens"] = np.array(
                [int(e[0].shape[0]) for e in p.entries], np.int64
            )
            n_leaf = len(p.entries[0]) if p.entries else 0
            blob[f"ing{i}_nleaf"] = np.int64(n_leaf)
            for j in range(n_leaf):
                # entries are host arrays already (submit_keys converts)
                blob[f"ing{i}_leaf{j}"] = np.concatenate(
                    [e[j] for e in p.entries]
                )
            blob[f"ing{i}_clients"] = np.array(
                list(p.wa.client_keys.keys()), dtype=str
            )
            blob[f"ing{i}_client_keys"] = np.array(
                list(p.wa.client_keys.values()), np.int64
            )
            if p.wa.reservoir is not None:
                blob[f"ing{i}_res"] = p.wa.reservoir.state()
            if p.sealed_at is not None:
                # the seal instant rides the checkpoint so a recovered
                # window's seal-to-hitters SLO observation survives the
                # restart (the replayed seal verb is a no-op on an
                # already-sealed pool and must not restamp the clock)
                blob[f"ing{i}_sealed_at"] = np.float64(p.sealed_at)
            if p.sk_root is not None:
                # the window's committed sketch-challenge root: a
                # recovered malicious window MUST replay the identical
                # challenge (a restarted server's fresh plane coin flip
                # would otherwise re-root the ratchet and turn the
                # re-run's slab openings into a <r - r', x> leak)
                blob[f"ing{i}_skroot"] = np.array(p.sk_root, np.uint32)

    @staticmethod
    def ingest_validate(z: dict, path: str) -> list | None:
        """Validate-before-mutate for the ``ing_*`` fields: parse every
        window's record fully (shapes cross-checked) BEFORE any pool is
        touched; a torn tail refuses loudly with live state intact.
        Returns the parsed per-window records, or None when the blob
        carries no ingest fields (a pre-streaming checkpoint)."""
        if "ing_windows" not in z:
            return None
        parsed = []
        ws = np.asarray(z["ing_windows"], np.int64)  # checkpoint blob: host
        for i, w in enumerate(ws):
            req_keys = {f"ing{i}_meta", f"ing{i}_sub_ids", f"ing{i}_sub_codes",
                        f"ing{i}_lens", f"ing{i}_nleaf"}
            missing = req_keys - set(z)
            if missing:
                raise RuntimeError(
                    f"tree_restore: checkpoint at {path} is missing ingest "
                    f"fields {sorted(missing)} (truncated write?)"
                )
            meta = np.array(z[f"ing{i}_meta"], np.int64)
            if meta.shape != (11,) or int(meta[0]) != int(w):
                raise RuntimeError(
                    f"tree_restore: checkpoint at {path} has a malformed "
                    f"ingest meta row for window {int(w)}"
                )
            lens = np.array(z[f"ing{i}_lens"], np.int64)
            n_leaf = int(z[f"ing{i}_nleaf"])
            if lens.shape[0] != int(meta[6]):
                raise RuntimeError(
                    f"tree_restore: ingest window {int(w)} entry table is "
                    f"torn ({lens.shape[0]} lengths vs {int(meta[6])} slots)"
                )
            leaves = []
            for j in range(n_leaf):
                key = f"ing{i}_leaf{j}"
                if key not in z:
                    raise RuntimeError(
                        f"tree_restore: ingest window {int(w)} is missing "
                        f"leaf {j} (truncated write?)"
                    )
                leaf = z[key]  # npz entries are host ndarrays
                if leaf.shape[0] != int(lens.sum()):
                    raise RuntimeError(
                        f"tree_restore: ingest window {int(w)} leaf {j} "
                        f"covers {leaf.shape[0]} keys, lengths sum to "
                        f"{int(lens.sum())}"
                    )
                leaves.append(leaf)
            sub_ids = z[f"ing{i}_sub_ids"]
            codes = np.array(z[f"ing{i}_sub_codes"], np.int64)
            if sub_ids.shape[0] != codes.shape[0]:
                raise RuntimeError(
                    f"tree_restore: ingest window {int(w)} verdict table "
                    "is torn"
                )
            parsed.append({
                "meta": meta,
                "lens": lens,
                "leaves": leaves,
                "sub_ids": sub_ids,
                "codes": codes,
                "clients": np.array(z.get(f"ing{i}_clients", [])),
                "client_keys": np.array(
                    z.get(f"ing{i}_client_keys", []), np.int64
                ),
                "res": (
                    np.array(z[f"ing{i}_res"], np.uint64)
                    if f"ing{i}_res" in z
                    else None
                ),
                # optional (blobs from before the SLO clock omit it)
                "sealed_at": (
                    float(z[f"ing{i}_sealed_at"])
                    if f"ing{i}_sealed_at" in z
                    else None
                ),
                # optional (semi-honest windows / older blobs omit it)
                "sk_root": (
                    np.array(z[f"ing{i}_skroot"], np.uint32)
                    if f"ing{i}_skroot" in z
                    else None
                ),
            })
        return parsed

    def ingest_restore_apply(self, parsed: list) -> None:
        """Rebuild the ingest pools from validated records (the mutation
        half of the restore contract)."""
        self._ingest_pools.clear()
        for rec in parsed:
            meta = rec["meta"]
            w = int(meta[0])
            wa = self._admission.window(w)
            pool = _WindowPool(w, wa)
            pool.sealed = bool(meta[1])
            pool.sealed_at = rec.get("sealed_at")
            pool.sk_root = rec.get("sk_root")
            pool.keys = int(meta[2])
            pool.admitted_keys = int(meta[3])
            pool.shed_keys = int(meta[4])
            pool.rejected = int(meta[5])
            wa.subs = int(meta[7])
            wa.keys = int(meta[8])
            wa.sub_keys = None if int(meta[9]) < 0 else int(meta[9])
            wa.pending_draws = int(meta[10])
            bounds = np.concatenate([[0], np.cumsum(rec["lens"])])
            pool.entries = [
                tuple(
                    leaf[bounds[e]:bounds[e + 1]] for leaf in rec["leaves"]
                )
                for e in range(len(rec["lens"]))
            ]
            for sid, code in zip(rec["sub_ids"], rec["codes"]):
                code = int(code)
                if code == self._ING_SHED:
                    resp = {"admitted": False, "shed": True, "window": w}
                elif code == self._ING_APPEND:
                    resp = {"admitted": True, "slot": None, "window": w}
                else:
                    resp = {"admitted": True, "slot": code, "window": w}
                pool.verdicts[str(sid)] = resp
            wa.client_keys = {
                str(c): int(n)
                for c, n in zip(rec["clients"], rec["client_keys"])
            }
            if rec["res"] is not None:
                wa.reservoir = native.Reservoir.from_state(rec["res"])
            self._ingest_pools[w] = pool


class SessionTable:
    """The bounded keyed table of :class:`CollectionSession` (JAX
    sessions.py:1009-1080).  ``get`` creates on first use; at
    ``cfg.collection_sessions_max`` an idle session (no keys, frontier or
    pools, no binding, not mid-verb) is evicted oldest first, else the new
    collection is refused: a server never drops a live tenant's state."""

    def __init__(self, server_id: int, cfg, device, ckpt_dir: str | None):
        self.server_id = server_id
        self.cfg = cfg
        self.device = device
        self.ckpt_dir = ckpt_dir
        self._by_key: dict = {}

    def __len__(self) -> int:
        return len(self._by_key)

    def keys(self) -> list:
        return list(self._by_key)

    def items(self) -> list:
        return list(self._by_key.items())

    def peek(self, key: str):
        return self._by_key.get(key)

    def default(self) -> CollectionSession:
        return self.get(DEFAULT_COLLECTION)

    def get(self, key: str | None = None) -> CollectionSession:
        key = check_key(key)
        cs = self._by_key.get(key)
        if cs is None:
            cap = max(1, self.cfg.collection_sessions_max)
            if len(self._by_key) >= cap:
                idle = sorted((k for k, s in self._by_key.items() if s.idle()),
                              key=lambda k: self._by_key[k].last_used)
                if idle:
                    del self._by_key[idle[0]]
            if len(self._by_key) >= cap:
                raise RuntimeError(
                    f"collection {key!r} would exceed the "
                    f"{cap}-session bound and no live session is idle "
                    f"(live: {sorted(self._by_key)})"
                )
            cs = self._by_key[key] = CollectionSession(key, self.server_id, self.cfg,
                                                       self.device, self.ckpt_dir)
        cs.last_used = time.monotonic()
        return cs


class _PlaneFailure:
    """Queue sentinel delivering a plane death to a blocked recv."""

    __slots__ = ("err",)

    def __init__(self, err: BaseException):
        self.err = err


class PlaneMux:
    """The server↔server socket demultiplexed per collection (JAX
    sessions.py:1083-1225).  Every frame is ``(channel, payload)`` (a
    third element, a traced JAX peer's header, is dropped); one pump task a
    transport routes payloads into per-channel FIFO queues, and each
    receiver reads only its own channel.  ``epoch`` counts transports: a
    session keyed against an older epoch re-keys before it trusts the plane
    again.  A dead transport reaches every blocked receiver as
    ``ConnectionError``, never as a hang."""

    # per-channel bound: each collection keeps a handful of frames in flight
    # (one exchange at a time under its verb lock), so reaching it means the
    # two servers' channels diverged: the plane fails loudly
    MAX_DEPTH = 1024

    def __init__(self, route_count=None):
        self.epoch = 0
        self._queues: dict = {}
        self._err: BaseException | None = None
        self._pump_task: asyncio.Task | None = None
        self._route_count = route_count  # (channel, framed bytes) of each frame routed

    def attach(self, reader, read_frame) -> int:
        """Bind to a fresh transport: fail every waiter of the old one (its
        frames can never arrive), reset the channels and start the new pump.
        ``read_frame(reader)`` -> (framed bytes, frame).  Returns the new
        epoch."""
        self.epoch += 1
        old, self._queues = self._queues, {}
        err = ConnectionError("data plane replaced by a new connection")
        for q in old.values():
            self._deliver_failure(q, err)
        self._err = None
        if self._pump_task is not None and not self._pump_task.done():
            self._pump_task.cancel()
        self._pump_task = asyncio.ensure_future(self._pump(reader, read_frame, self.epoch))
        return self.epoch

    def close(self) -> None:
        if self._pump_task is not None and not self._pump_task.done():
            self._pump_task.cancel()
        self.fail(ConnectionError("data plane closed"))

    def fail(self, err: BaseException) -> None:
        """Fail every current and future recv with ``err`` (until the next
        :meth:`attach`)."""
        self._err = err
        for q in self._queues.values():
            self._deliver_failure(q, err)

    @staticmethod
    def _deliver_failure(q: asyncio.Queue, err: BaseException) -> None:
        try:
            q.put_nowait(_PlaneFailure(err))
        except asyncio.QueueFull:
            # drop one data frame to make room: the plane is dead, the
            # waiter must learn it either way
            try:
                q.get_nowait()
            except asyncio.QueueEmpty:
                pass
            q.put_nowait(_PlaneFailure(err))

    def _queue(self, chan: str) -> asyncio.Queue:
        q = self._queues.get(chan)
        if q is None:
            q = self._queues[chan] = asyncio.Queue(maxsize=self.MAX_DEPTH)
        return q

    async def recv(self, chan: str):
        """The next payload on ``chan`` (FIFO per channel).  Raises the
        plane's death as ``ConnectionError``, the failure a direct socket
        read gave, so every recovery path works unchanged."""
        if self._err is not None:
            raise ConnectionError(f"data plane down: {self._err!r}") from self._err
        q = self._queue(chan)
        item = await q.get()
        if isinstance(item, _PlaneFailure):
            # leave the failure visible to any later recv on this channel
            self._deliver_failure(q, item.err)
            raise ConnectionError(f"data plane down: {item.err!r}") from item.err
        return item

    async def _pump(self, reader, read_frame, epoch: int) -> None:
        """Route frames until the transport dies.  A pump outliving its
        epoch (superseded by :meth:`attach`) exits quietly: its queues were
        failed and replaced already."""
        try:
            while True:
                nbytes, frame = await read_frame(reader)
                if epoch != self.epoch:
                    return
                chan = frame[0]
                if self._route_count is not None:
                    self._route_count(chan, nbytes)
                self._queue(chan).put_nowait(frame[1])
        except asyncio.CancelledError:
            raise
        except Exception as e:  # EOF, a reset, a diverged channel: a plane death
            if epoch == self.epoch:
                self.fail(e)
