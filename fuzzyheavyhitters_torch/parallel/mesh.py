"""Device-mesh execution of the two-server protocol, in one process or two.

The port of ``fuzzyheavyhitters_tpu/parallel/mesh.py``.  The mesh is
2 × k shards:

- axis ``servers`` (2): the two parties.  Party p's keys and frontier live
  on the shards of row p.  The inter-party traffic of a trusted level is
  one packed 32-bit word of share bits per (node, client), swapped between
  the rows (the JAX ``ppermute``);
- axis ``data`` (k): client data parallelism.  The N clients split into k
  blocks of N/k; per-node counts and share sums finish with a sum over the
  row's shards (the JAX ``psum``).

A shard is a ``torch.device`` (:func:`make_mesh`): by default the visible
cards in order, wrapping onto the same card when there are fewer cards
than shards, so a 2 × 4 mesh runs as eight logical shards on one card.
The collectives of the JAX programs become explicit operations: in one
process the rows' tensors are handed over (moved to the receiving shard's
device); in two processes (:func:`init_distributed`, one row each) they
are gloo ``isend``/``irecv`` pairs and ``all_reduce`` over a process group
that :class:`_Link` stages through host buffers, pinned for a card's
tensors.  A collective that fails raises; nothing is retried elsewhere.

The JAX bodies are SPMD: every shard of both rows runs both roles of a
secure level and throws the wrong role's half away.  Here each role runs
only on the row that owns it (the garbler row encrypts or garbles, the
evaluator row decrypts or evaluates), with the same kept values and the
same OT-stream accounting, so a secure level launches k of each kernel
its equality path uses.  Shards keep the port's plane-major frontier
(``collect``); :meth:`MeshRunner.snapshot` speaks the JAX package's
interleaved layout.

As in the JAX package the mesh is one trust domain: in two processes,
process 0 agrees the secure session material and broadcasts it.  Use the
socket deployment (``bin.server`` × 2 and ``bin.leader``) for two
administrative domains.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..obs import metrics as obsmetrics
from ..ops import gc, otext
from ..ops.fields import _M32, F255, FE62, _shr
from ..ops.ibdcf import EvalState, IbDcfKeyBatch
from ..protocol import collect, driver, secure

SERVERS = "servers"
DATA = "data"
COUNTERS = ("recoveries", "levels_rerun", "shards_rerun", "crawl_checkpoints",
            "device_fetches")


def field_psum(field, v: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Modular sum of field elements over the shards stacked along ``dim``.

    FE62 sums the 32-bit halves of the (lazily reduced) words exactly in
    int64 and recombines ``lo + hi·2^32`` mod p; F255 sums limbs in int64,
    runs one carry chain, folds 2^256 ≡ 38 twice and subtracts p twice.
    The words equal the JAX package's ``field_psum`` over a mesh axis."""
    if field is F255:
        return F255.sum(v, dim=dim)
    lo = (v & _M32).sum(dim=dim)
    hi = _shr(v, 32).sum(dim=dim)
    return field.add(field.new(lo), field.mul(field.new(hi),
                                              field.from_int(1 << 32, v.device)))


def init_distributed(coordinator: str | None, num_processes: int, process_id: int) -> None:
    """Join the two-process mesh: a gloo process group at
    ``tcp://<coordinator>`` (``host:port``), process p holding mesh row p.
    NCCL is not used: it refuses two ranks on one card, the shape a
    one-card host runs."""
    import torch.distributed as dist

    if num_processes not in (1, 2):
        raise ValueError(f"the mesh runs in one process or two (one row each), "
                         f"not {num_processes}")
    if coordinator is None:
        raise ValueError("a multi-process mesh needs --coordinator host:port")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def agree(obj):
    """``obj`` as process 0 of the two-process mesh holds it, on every
    process (the pickled object is broadcast: one trust domain); ``obj``
    itself in one process."""
    import torch.distributed as dist

    if _process_rank() is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _process_rank() -> int | None:
    """This process's mesh row in a two-process group; None in one process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == 2:
        return dist.get_rank()
    return None


@dataclass(frozen=True)
class Mesh:
    """2 × k shards: ``devices[p][j]`` holds shard j of party p."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {SERVERS: 2, DATA: len(self.devices[0])}

    def placement(self) -> list:
        return [[str(d) for d in row] for row in self.devices]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2 × (n/2) mesh: the first half of the shards party 0's row, the rest
    party 1's.  ``devices`` lists them; by default the first ``n_devices``
    (all when None) of the visible cards in order, wrapping onto the same
    card when ``n_devices`` exceeds the card count."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')] "
                               "* n for logical shards on the host")
        devices = [torch.device("cuda", i % count) for i in range(n_devices or count)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % 2 or n == 0:
        raise ValueError(f"need an even device count for the 2-server axis, got {n}")
    return Mesh(devices=(tuple(devices[:n // 2]), tuple(devices[n // 2:])))


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class _Link:
    """The collectives between the mesh's two rows.  ``rank`` None: both
    rows in this process, hand-overs between tensors.  Otherwise this
    process holds row ``rank`` of a two-process gloo group: tensors are
    staged through host buffers (pinned for a card's tensors), sent in the
    same order on both processes, and counted in ``bytes_sent`` /
    ``bytes_received``."""

    def __init__(self, rank: int | None):
        self.rank = rank
        self.bytes_sent = 0
        self.bytes_received = 0

    @property
    def rows(self) -> tuple:
        return (0, 1) if self.rank is None else (self.rank,)

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        t = _wire(t)
        if t.device.type == "cpu":
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _exchange(self, send: list | None, like: list | None) -> list | None:
        """Post every send, then every receive, to the peer; wait for all.
        ``like`` lists (shape, dtype, device) of the tensors to receive."""
        import torch.distributed as dist

        peer = 1 - self.rank
        reqs, out = [], []
        for t in send or ():
            buf = self._stage(t)
            reqs.append(dist.isend(buf, peer))
            out.append(buf)  # kept alive until the wait
            self.bytes_sent += buf.numel() * buf.element_size()
        bufs = []
        for shape, dtype, dev in like or ():
            wd = torch.uint8 if dtype == torch.bool else dtype
            buf = torch.empty(shape, dtype=wd, pin_memory=dev.type == "cuda")
            reqs.append(dist.irecv(buf, peer))
            bufs.append((buf, dtype, dev))
        for r in reqs:
            r.wait()
        got = []
        for buf, dtype, dev in bufs:
            self.bytes_received += buf.numel() * buf.element_size()
            got.append(buf.to(dev, non_blocking=True).to(dtype))
        return got if like is not None else None

    def transfer(self, src: int, tensors: list | None, like: list) -> list | None:
        """Row ``src``'s tensors to row ``1 - src`` (one per shard, onto the
        receiving shard's device given in ``like``): the received list where
        this process holds the receiving row, else None."""
        if self.rank is None:
            return [t.to(dev) for t, (_, _, dev) in zip(tensors, like)]
        if self.rank == src:
            return self._exchange(tensors, None)
        return self._exchange(None, like)

    def swap(self, per_row: dict) -> dict:
        """Each row's tensors to the other row, both ways at once (the rows
        hold tensors of equal shapes): ``{p: the peer row's list}``."""
        if self.rank is None:
            return {p: [t.to(o.device) for t, o in zip(per_row[1 - p], per_row[p])]
                    for p in (0, 1)}
        mine = per_row[self.rank]
        like = [(t.shape, t.dtype, t.device) for t in mine]
        return {self.rank: self._exchange(mine, like)}

    def sum_rows(self, per_row: dict) -> torch.Tensor:
        """The sum over both rows of one tensor per row (on the host)."""
        if self.rank is None:
            return per_row[0].cpu() + per_row[1].cpu()
        import torch.distributed as dist

        buf = per_row[self.rank].cpu().contiguous()
        dist.all_reduce(buf)
        self.bytes_sent += buf.numel() * buf.element_size()
        self.bytes_received += buf.numel() * buf.element_size()
        return buf

    def gather_rows(self, per_row: dict) -> torch.Tensor:
        """Both rows' tensors stacked [2, ...] on the host: a one-hot
        placement summed over the rows (one contributor per slot)."""
        if self.rank is None:
            return torch.stack([per_row[0].cpu(), per_row[1].cpu()])
        mine = per_row[self.rank].cpu()
        both = torch.zeros((2,) + tuple(mine.shape), dtype=mine.dtype)
        both[self.rank] = mine
        return self.sum_rows({self.rank: both})


def _tweak(seeds: np.ndarray, word: int, value: int) -> np.ndarray:
    out = np.array(seeds, np.uint32, copy=True)
    out[..., word] ^= np.uint32(value)
    return out


def _shard_keys(kb: IbDcfKeyBatch, j: int, nl: int, dev) -> IbDcfKeyBatch:
    """Clients [j·nl, (j+1)·nl) of a party's keys on ``dev``.  The root
    seeds are copied: keygen's are views of one tensor that holds both
    parties' seeds, which a process holding one row must not keep."""
    part = IbDcfKeyBatch(*(a[j * nl:(j + 1) * nl].to(dev) for a in kb))
    return part._replace(root_seed=part.root_seed.clone())


class MeshRunner:
    """Holds the parties' device state over the mesh's shards: ``keys[p][j]``,
    ``alive_keys[p][j]``, ``frontier[p][j]`` for each row p this process
    holds (both in one process, its own in two) and shard j < k.  The PRG
    bit mode (``prg.DERIVED_BITS``) is the one the expand kernel reads at
    each call, as in ``driver.Leader``."""

    def __init__(self, mesh: Mesh, keys0: IbDcfKeyBatch | None, keys1: IbDcfKeyBatch | None,
                 f_max: int, secure_exchange: bool = False, min_bucket: int = 1, *,
                 session: dict | None = None):
        self.mesh = mesh
        self.f_max = f_max
        self.min_bucket = min_bucket
        self.secure = secure_exchange
        self.link = _Link(_process_rank())
        given = {0: keys0, 1: keys1}
        k = mesh.shape[DATA]
        some = next(given[p] for p in self.link.rows if given[p] is not None)
        n = some.key_idx.shape[0]
        if n % k:
            raise ValueError(f"client count {n} must divide the data axis {k}")
        self.n_clients, self.n_local = n, n // k
        self.n_dims = some.cw_seed.shape[1]
        self.data_len = some.cw_seed.shape[-2]
        nl = self.n_local
        self.keys = {p: [_shard_keys(given[p], j, nl, mesh.devices[p][j])
                         for j in range(k)] for p in self.link.rows}
        self.alive_keys = {p: [torch.ones(nl, dtype=torch.bool, device=dev)
                               for dev in mesh.devices[p]] for p in self.link.rows}
        self.frontier: dict | None = None
        self._children: dict | None = None
        self._masks = collect.pattern_masks(self.n_dims)
        if secure_exchange:
            self._setup_secure(session)

    @classmethod
    def from_process_local(cls, mesh: Mesh, my_keys: IbDcfKeyBatch, f_max: int,
                           secure_exchange: bool = False, min_bucket: int = 1, *,
                           session: dict | None = None) -> "MeshRunner":
        """Two-process construction: this process holds mesh row p (its
        rank) and supplies only party p's key batch, so no tensor of the
        peer party's keys exists here."""
        rank = _process_rank()
        if rank is None:
            raise ValueError("from_process_local is the two-process shape")
        keys = (my_keys, None) if rank == 0 else (None, my_keys)
        return cls(mesh, *keys, f_max, secure_exchange=secure_exchange,
                   min_bucket=min_bucket, session=session)

    @property
    def rows(self) -> tuple:
        return self.link.rows

    def _shards(self):
        for p in self.rows:
            for j in range(self.mesh.shape[DATA]):
                yield p, j

    def _setup_secure(self, session: dict | None) -> None:
        """Base-OT material for the on-mesh 2PC, one session per garbling
        direction (``driver.session_material``: both sessions' (s, seeds0,
        seeds1, chosen) and ``sec_seed``), agreed from process 0.  In
        session g row g is the extension sender (garbler), row 1 - g the
        receiver; shard j's column seeds carry j in word 3 (never word 0,
        the CTR word), so no two shards share a column stream."""
        mat = session if session is not None else (
            driver.session_material() if self.link.rank in (None, 0) else None)
        mat = agree(mat)
        k = self.mesh.shape[DATA]
        self._snd, self._rcv = {}, {}
        for g, (s_bits, seeds0, seeds1, chosen) in enumerate(mat["sessions"]):
            if g in self.rows:
                self._snd[g] = [otext.OtExtSender(s_bits, _tweak(chosen, 3, j),
                                                  self.mesh.devices[g][j]) for j in range(k)]
            if 1 - g in self.rows:
                self._rcv[g] = [otext.OtExtReceiver(_tweak(seeds0, 3, j), _tweak(seeds1, 3, j),
                                                    self.mesh.devices[1 - g][j])
                                for j in range(k)]
        self._sec_seed = np.asarray(mat["sec_seed"], np.uint32)
        self._crawl_ctr = 0

    # -- leader-facing ops --------------------------------------------------

    def tree_init(self) -> None:
        self.frontier = {p: [collect.tree_init(kb, self.min_bucket) for kb in self.keys[p]]
                         for p in self.rows}
        self._children = None

    def _expand(self, level: int, last: bool) -> dict:
        """Every held shard's expansion: ``{p: [packed]}``; the child caches
        go to ``_children`` (None at the last level)."""
        packed, children = {}, {}
        for p, j in self._shards():
            pk, ch = collect.expand_share_bits(self.keys[p][j], self.frontier[p][j], level,
                                               want_children=not last)
            packed.setdefault(p, []).append(pk)
            children.setdefault(p, []).append(ch)
        self._children = None if last else children
        return packed

    def level_counts(self, level: int, last: bool = False) -> np.ndarray:
        """Trusted counts uint32[F, 2^d] for every child of the frontier:
        expand, swap the packed words between the rows, compare, sum over
        the row's shards, then over the rows halved (both rows count the
        same).  ``last`` builds no child cache."""
        packed = self._expand(level, last)
        peer = self.link.swap(packed)
        cnt = {}
        for p in self.rows:
            dev = self.mesh.devices[p][0]
            parts = [collect.counts_by_pattern(packed[p][j], peer[p][j], self._masks,
                                               self.alive_keys[p][j],
                                               self.frontier[p][j].alive).to(dev)
                     for j in range(len(packed[p]))]
            cnt[p] = torch.stack(parts).sum(0)
        return (self.link.sum_rows(cnt) // 2).numpy().astype(np.uint32)

    def level_count_shares(self, level: int, field=FE62, last: bool = False) -> np.ndarray:
        """Secure level: both parties' additive count shares [2, F, 2^d
        (, 8)] in the JAX package's words (FE62 uint64, F255 uint32 limbs),
        replicated on every process; reconstruct as ``field.sub(sh[0],
        sh[1])``.  The garbler is ``level % 2``; S = 2·n_dims takes the
        1-of-2^S table when ``secure._ot4_use(S)`` (the module's
        ``EQ_OT4``, never a config's ``ot_path``), else the delta garbled
        circuit and the b2a OT.  ``last`` builds no child cache."""
        if not self.secure:
            raise RuntimeError("runner built without secure_exchange")
        g = level % 2
        ev = 1 - g
        self._crawl_ctr += 1
        gseed = secure.derive_seed(self._sec_seed, 1, level, self._crawl_ctr)
        bseed = secure.derive_seed(self._sec_seed, 2, level, self._crawl_ctr)
        d, k = self.n_dims, self.mesh.shape[DATA]
        S, C = 2 * d, 1 << d
        W = secure.payload_words(field)
        F = self.frontier[self.rows[0]][0].f_bucket
        B = F * C * self.n_local
        m = B * S
        devs = self.mesh.devices
        flat = {p: [secure.child_strings(pk, d).reshape(B, S) for pk in pks]
                for p, pks in self._expand(level, last).items()}
        # shard j's GC and b2a seeds carry j << 16 in word 2 (clear of
        # derive_seed's purpose tag; word 0 is the CTR word)
        gs = [_tweak(gseed, 2, j << 16) for j in range(k)]
        bs = [_tweak(bseed, 2, j << 16) for j in range(k)]
        like = lambda shape, dtype, row: [(shape, dtype, devs[row][j]) for j in range(k)]
        u = t = base = None
        if ev in self.rows:
            u, t, base = zip(*(secure.ev_step1_fused(self._rcv[g][j], flat[ev][j])
                               for j in range(k)))
        u = self.link.transfer(ev, u and list(u), like((otext.KAPPA, -(-m // 32)),
                                                         torch.int32, g))
        vals = {}
        if secure._ot4_use(S):
            # the 1-of-2^S table: two transfers a level (u, the table)
            cts = None
            if g in self.rows:
                cts, vals[g] = [], []
                for j, snd in enumerate(self._snd[g]):
                    idx0 = snd.consumed
                    q = snd.extend(m, u[j]).reshape(B, S, 4)
                    r1, w0, w1 = secure.b2a_payload_pair(field, bs[j], B, g, q.device)
                    # result 1 (strings equal) -> the evaluator learns r0
                    cts.append(secure.ot2s_encrypt(q, snd.s_block, flat[g][j], w1, w0, W, idx0))
                    vals[g].append(r1)
            cts = self.link.transfer(g, cts, like((1 << S, B, W), torch.int32, ev))
            if ev in self.rows:
                vals[ev] = []
                for j in range(k):
                    w = secure.ot2s_decrypt(t[j].reshape(B, S, 4), flat[ev][j], cts[j], W,
                                           base[j])
                    vals[ev].append(secure.words_to_field(field, w))
        else:
            # the garbled circuit and the b2a OT: five transfers a level
            batch = masks = None
            if g in self.rows:
                batch, masks = zip(*(secure.gb_step1(self._snd[g][j], u[j], flat[g][j], gs[j])
                                     for j in range(k)))
            parts = [self.link.transfer(g, batch and [getattr(b, f) for b in batch],
                                        like(shape, dtype, ev))
                     for f, shape, dtype in (("tables", (B, S - 1, 2, 4), torch.int32),
                                             ("gb_labels", (B, S, 4), torch.int32),
                                             ("decode", (B,), torch.bool))]
            e = u2 = t2 = idx = None
            if ev in self.rows:
                e = [secure.ev_step2(gc.GarbledEqBatch(*(pt[j] for pt in parts)), t[j],
                                     B, S) for j in range(k)]
                u2, t2, idx = zip(*(secure.ev_step3(self._rcv[g][j], e[j]) for j in range(k)))
            u2 = self.link.transfer(ev, u2 and list(u2), like((otext.KAPPA, -(-B // 32)),
                                                              torch.int32, g))
            c01 = None
            if g in self.rows:
                c0, c1, vals[g] = zip(*(secure.gb_step2(self._snd[g][j], u2[j], masks[j], bs[j],
                                                        field, g) for j in range(k)))
                c01 = list(c0) + list(c1)
            c01 = self.link.transfer(g, c01, like((B, W), torch.int32, ev) * 2)
            if ev in self.rows:
                vals[ev] = [secure.ev_step4(self._rcv[g][j], t2[j], idx[j], c01[j], c01[k + j],
                                            e[j], field) for j in range(k)]
        shares = {}
        for p in self.rows:
            sums = []
            for j in range(k):
                fr = self.frontier[p][j]
                wgt = secure.alive_weight(fr.alive, self.alive_keys[p][j], C)
                v = vals[p][j].reshape((F, C, self.n_local) + field.limb_shape)
                sums.append(secure.node_share_sums(field, v, wgt).to(devs[p][0]))
            shares[p] = field_psum(field, torch.stack(sums), 0)
        both = self.link.gather_rows(shares)
        return both.numpy().view(np.uint64) if field is FE62 else both.numpy().view(np.uint32)

    def advance(self, level: int, parent_idx, pattern_bits, n_alive: int) -> None:
        if self._children is None:
            raise RuntimeError("advance before level_counts")
        parent = torch.from_numpy(np.asarray(parent_idx, np.int64))
        pat = torch.from_numpy(np.asarray(pattern_bits, bool))
        self.frontier = {p: [collect.advance_from_children(
            self._children[p][j], parent.to(self.mesh.devices[p][j]),
            pat.to(self.mesh.devices[p][j]), n_alive) for j in range(len(self._children[p]))]
            for p in self.rows}
        self._children = None

    # -- checkpoint / restore ------------------------------------------------

    def snapshot(self) -> dict:
        """Host copy of the crawl state in the JAX package's layout: seed
        uint32[2, F, N, d, 2, 4], bit / y_bit bool[2, F, N, d, 2], alive
        bool[2, F], alive_keys bool[2, N], clients in global order.  In two
        processes the rows are swapped once so each holds both.  Keys are
        not included (they never change mid-crawl)."""
        if self.frontier is None:
            raise RuntimeError("snapshot before tree_init")
        rows = {}
        for p in self.rows:
            parts = [collect.to_interleaved(fr.states) for fr in self.frontier[p]]
            # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (checkpoint snapshot: each row's planes come to the host once per checkpoint, not per level)
            rows[p] = [torch.cat([getattr(s, f) for s in parts], dim=1).cpu()
                       for f in ("seed", "bit", "y_bit")]
            # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (as above)
            rows[p] += [self.frontier[p][0].alive.cpu(),
                        # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (as above)
                        torch.cat(self.alive_keys[p]).cpu()]
        if self.link.rank is not None:
            rows[1 - self.link.rank] = self.link.swap(rows)[self.link.rank]
        # fhh-lint: disable=chunked-device-readback (host tensors: the rows were read back above)
        snap = {f: torch.stack([rows[0][i], rows[1][i]]).contiguous().numpy()
                for i, f in enumerate(("seed", "bit", "y_bit", "alive", "alive_keys"))}
        snap["seed"] = snap["seed"].view(np.uint32)
        return snap

    def restore(self, snap: dict) -> None:
        """Put a :meth:`snapshot` (this package's or the JAX package's) back on
        the shards; the child cache is dropped (its level never advanced)."""
        nl = self.n_local
        frontier, alive_keys = {}, {}
        for p in self.rows:
            frontier[p], alive_keys[p] = [], []
            for j, dev in enumerate(self.mesh.devices[p]):
                cl = slice(j * nl, (j + 1) * nl)
                # fhh-lint: disable=chunked-device-readback,host-sync-in-hot-loop (restore path: host snapshot entries, once per recovery)
                raw = EvalState(seed=np.asarray(snap["seed"][p][:, cl], np.uint32),
                                bit=snap["bit"][p][:, cl], y_bit=snap["y_bit"][p][:, cl])
                frontier[p].append(collect.Frontier(
                    states=collect.states_from_numpy(raw, dev),
                    alive=torch.from_numpy(np.array(snap["alive"][p], bool)).to(dev)))
                alive_keys[p].append(torch.from_numpy(
                    np.array(snap["alive_keys"][p][cl], bool)).to(dev))
        self.frontier, self.alive_keys = frontier, alive_keys
        self._children = None


class MeshLeader:
    """Level-loop driver over a :class:`MeshRunner` (leader.rs:185-297, the
    bookkeeping of ``driver.Leader``).  Its registry ``obs`` (``mesh``, JAX
    mesh.py:636-790) holds the last crawl's ``level`` spans, survivors and
    counters; ``counters`` reads ``recoveries``, ``levels_rerun``,
    ``shards_rerun``, ``crawl_checkpoints`` and ``device_fetches`` from it;
    ``survivors`` the surviving node count per level; ``timings["level"]``
    each level's host seconds; ``emit(event, **fields)`` receives
    ``resilience.mesh_recover`` events."""

    def __init__(self, runner: MeshRunner, emit=None):
        self.r = runner
        self.paths = None
        self.n_nodes = 0
        self.emit = emit or (lambda event, **kw: None)
        self.obs = obsmetrics.Registry("mesh")
        self._reset()

    @property
    def counters(self) -> dict:
        return {c: int(self.obs.counter_value(c)) for c in COUNTERS}

    def _reset(self) -> None:
        """A crawl's figures start from zero (the counters zero-touched, so
        a fault-free run reports its zeros)."""
        self.obs.reset()
        for c in COUNTERS:
            self.obs.count(c, 0)
        self.survivors = {}
        self.timings = {"level": []}

    def _level_counts(self, level: int) -> np.ndarray:
        """Trusted counts, or in a secure crawl the leader's reconstruction
        ``sh0 - sh1`` (FE62 inner levels, F255 last, rpc.rs:60-62)."""
        r = self.r
        last = level == r.data_len - 1
        self.obs.count("device_fetches", level=level)  # the counts, or the shares
        if not r.secure:
            return r.level_counts(level, last=last)
        if last:
            sh = r.level_count_shares(level, F255, last=True)
            v = F255.np_sub(sh[0], sh[1])
            if np.any(v[..., 1:]):
                raise RuntimeError("non-count residue in F255 mesh shares")
            return v[..., 0].astype(np.uint32)
        sh = r.level_count_shares(level, FE62)
        v = FE62.np_canon(FE62.np_sub(sh[0], sh[1]))
        if np.any(v > r.n_clients):  # e.g. a share-sign or role mismatch
            raise RuntimeError("count reconstruction out of range")
        return v.astype(np.uint32)

    def _run_one_level(self, level: int, nreqs: int, threshold: float):
        """One count -> threshold -> prune -> advance round; the kept counts,
        or None when no node survives."""
        with self.obs.span("level", level=level):
            return self._one_level(level, nreqs, threshold)

    def _one_level(self, level: int, nreqs: int, threshold: float):
        r = self.r
        t0 = time.perf_counter()
        counts = self._level_counts(level)
        keep = counts >= max(1, int(threshold * nreqs))  # leader.rs:193-194
        keep[self.n_nodes:, :] = False
        parent, pattern, n_alive = collect.compact_survivors(keep, r.f_max, r.min_bucket)
        pat_bits = collect.pattern_to_bits(pattern, r.n_dims)
        self.survivors[level] = n_alive
        self.obs.gauge("survivors", n_alive, level=level)
        if n_alive == 0:
            return None
        if level < r.data_len - 1:  # nothing advances past the leaves
            r.advance(level, parent, pat_bits, n_alive)
        self.paths = np.concatenate([self.paths[parent[:n_alive]],
                                     pat_bits[:n_alive, :, None]], axis=-1)
        self.n_nodes = n_alive
        self.timings["level"].append(time.perf_counter() - t0)
        return counts[parent[:n_alive], pattern[:n_alive]]

    def _start(self) -> None:
        self.r.tree_init()
        self.paths = np.zeros((1, self.r.n_dims, 0), bool)
        self.n_nodes = 1

    def _empty(self, level: int) -> driver.CrawlResult:
        return driver.CrawlResult(paths=np.zeros((0, self.r.n_dims, level + 1), bool),
                                  counts=np.zeros(0, np.uint32))

    def run(self, nreqs: int, threshold: float) -> driver.CrawlResult:
        self._reset()
        self._start()
        counts_kept = np.zeros(0, np.uint32)
        for level in range(self.r.data_len):
            counts_kept = self._run_one_level(level, nreqs, threshold)
            if counts_kept is None:
                return self._empty(level)
        return driver.CrawlResult(paths=self.paths, counts=counts_kept)

    def run_supervised(self, nreqs: int, threshold: float, *, checkpoint_every: int = 2,
                       max_recoveries: int = 4, chaos=None) -> driver.CrawlResult:
        """:meth:`run` with host snapshots every ``checkpoint_every`` levels
        and recovery matched to the fault (``resilience.chaos.MeshFaultError``):
        device state intact (a dropped shard) re-runs the level; device
        state lost (a killed participant) restores the last snapshot and
        re-runs the levels since, or restarts the crawl when none was
        taken.  ``chaos`` (a ``MeshChaos``) fires its faults before each
        level.  Counts are deterministic, so a recovered crawl's hitters
        equal a fault-free one's (a secure re-run draws fresh shares that
        reconstruct the same counts)."""
        from ..resilience.chaos import MeshFaultError

        self._reset()
        r = self.r
        self._start()
        counts_kept = np.zeros(0, np.uint32)
        stash = None  # (level, snapshot, paths, n_nodes, counts_kept)
        level = 0
        while level < r.data_len:
            try:
                if chaos is not None:
                    chaos.before_level(r, level)
                counts_kept = self._run_one_level(level, nreqs, threshold)
                if counts_kept is None:
                    return self._empty(level)
                if level < r.data_len - 1 and (level + 1) % checkpoint_every == 0:
                    stash = (level, r.snapshot(), self.paths.copy(), self.n_nodes,
                             counts_kept.copy())
                    self.obs.count("crawl_checkpoints", level=level)
                level += 1
            except MeshFaultError as err:
                self.obs.count("recoveries")
                self.emit("resilience.mesh_recover", level=level,
                          attempt=self.counters["recoveries"], state_lost=err.state_lost,
                          error=str(err))
                if self.counters["recoveries"] > max_recoveries:
                    raise
                if not err.state_lost and r.frontier is not None:
                    self.obs.count("shards_rerun", level=level)  # only this level is suspect
                    continue
                self.obs.count("levels_rerun")
                if stash is not None:
                    lvl, snap, paths, n_nodes, kept = stash
                    r.restore(snap)
                    self.paths, self.n_nodes, counts_kept = paths.copy(), n_nodes, kept.copy()
                    level = lvl + 1
                else:  # no snapshot yet: restart the crawl
                    self._start()
                    counts_kept = np.zeros(0, np.uint32)
                    level = 0
        return driver.CrawlResult(paths=self.paths, counts=counts_kept)
