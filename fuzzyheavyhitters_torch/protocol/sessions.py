"""The trusted exchange's shared mask stream (the slice of the JAX
package's ``protocol/sessions.py`` that the socket deployment uses).

In trusted mode both servers hold the plaintext counts; server 0 answers
``count + r`` and server 1 answers ``r``, with ``r`` drawn from one stream
both derive from a public seed, so the leader's ``v0 - v1`` reconstruction
is the same as in secure mode (the reference hardcodes the seed,
server.rs:331-332).  A wire-format shim, not a secret: secrecy comes from
``secure_exchange``.  Host NumPy on purpose: the rows are tiny (F · 2^d
elements a level).

It also holds the streaming front door's state (:class:`IngestState`): the
window pools (:class:`_WindowPool`), the admission gate, and their
checkpoint fields (``ing_*``, the JAX blob's, field for field), which the
JAX package keeps on each ``CollectionSession``.  The port's server has one
collection, so it holds one :class:`IngestState`; the multi-tenant
collection sessions of that module are not ported.
"""

from __future__ import annotations

import asyncio

import numpy as np

from .. import native
from ..ops import prg
from ..ops.fields import F255, FE62
from ..resilience import admission

DEFAULT_COLLECTION = "default"
SHARED_MASK_SEED = b"XXX This is bog\x00"  # 16 B, ref: server.rs:331-332


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


class IngestState:
    """The streaming front door of one collection (the ingest half of the
    JAX ``CollectionSession``): the live window pools, bounded by
    ``cfg.ingest_windows_retained``, and the admission gate built from the
    ``ingest_*`` config fields.  ``submit_keys`` runs the gate's arithmetic
    in an executor behind ``_adm_gate``, so decisions stay serialized while
    the event loop serves other verbs."""

    def __init__(self, cfg):
        self.cfg = cfg
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

    # verdict codes in the checkpoint blob: slot >= 0, -1 = appended in
    # arrival order (no slot), -2 = reservoir-shed
    _ING_APPEND, _ING_SHED = -1, -2

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
