"""One collector server's data shards: the client axis split over the
server's own devices (the port of ``fuzzyheavyhitters_tpu/parallel/
server_mesh.py``).

``parallel/mesh.py`` is the whole-protocol mesh, both parties in one trust
domain.  This module is the socket deployment's complement: each
:class:`~..protocol.rpc.CollectorServer` keeps its own shards and splits
only the client axis across them.  A crawl's cost is linear in clients per
level, and the client axis is independent until the per-node reduction,
so:

- the key batch, the frontier's eval states and each level's expansion
  live per shard, ``N / k`` clients each (the expand kernel runs once per
  shard on its slice);
- trusted per-node counts are taken per shard and summed (exact) before
  anything reaches the wire, so the wire carries what one device would
  send;
- the secure kernel stage runs row-sharded over the same devices
  (``parallel/kernel_shard.py``, whose field share sums fold with
  :func:`parallel.mesh.field_psum`) with a byte-identical wire.  A level
  too small for it gathers its share bits onto the first shard
  (:meth:`ServerMesh.gather`) and runs the whole-level path there.

Per-shard tensors travel as :class:`Sharded` lists, which remember the
axis they split.

Placement departs from the JAX package on purpose.  Its
``resolve_data_devices`` caps an explicit request at the visible device
count; here, as in ``parallel.mesh.make_mesh``, an explicit ``N > 1`` gives
N logical shards placed round-robin on the visible cards (on a one-card
host, N shards of that card) and on the CPU N logical CPU shards.  The
auto setting 0 resolves as the JAX package does: the visible cards on a
card host, 1 on the CPU.  Results are bit-identical at every shard count,
so this is a placement choice: it lets a one-card host run a sharded
server.
"""

from __future__ import annotations

import torch

from ..ops import ibdcf
from ..ops.ibdcf import EvalState
from ..protocol import collect
from ..utils import resolve_device


class Sharded(list):
    """The per-shard parts of one logical tensor, in shard order, split
    along ``dim`` (each part on its shard's device)."""

    def __init__(self, parts, dim: int):
        super().__init__(parts)
        self.dim = dim


def resolve_data_devices(requested: int, device=None) -> int:
    """How many data shards a server's mesh should span.  ``requested`` 0
    is auto: the visible cards when the server runs on a card (``device``,
    by default the card when there is one), 1 on the CPU.  An explicit
    request is taken as it is: shards wrap onto the visible cards
    (:func:`shard_devices`)."""
    if requested > 0:
        return int(requested)
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    return max(1, torch.cuda.device_count()) if on_card else 1


def shard_devices(n: int, device) -> tuple:
    """``n`` shard devices for a server on ``device``: CPU shards on the
    CPU; on a card, the visible cards round-robin from the server's own."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,) * n
    count = torch.cuda.device_count()
    base = dev.index or 0
    return tuple(torch.device("cuda", (base + i) % count) for i in range(n))


def _largest_divisor_leq(n: int, k: int) -> int:
    """Largest divisor of ``n`` that is <= ``k``: shard counts tile the
    client batch exactly."""
    k = max(1, min(k, n)) if n > 0 else 1
    while n % k:
        k -= 1
    return k


def split_even(x: torch.Tensor, devices, dim: int) -> Sharded:
    """``x`` cut into ``len(devices)`` equal parts along ``dim``, part j
    on ``devices[j]`` (a part on the same device is a view)."""
    n = x.shape[dim] // len(devices)
    return Sharded([x.narrow(dim, j * n, n).to(dev) for j, dev in enumerate(devices)], dim)


class ServerMesh:
    """One collector server's data shards.  Construct with the device
    budget (:func:`resolve_data_devices`) and the server's device, then
    :meth:`bind` to a client batch: the active shard count is the largest
    divisor of the batch within the budget, so a prime batch degrades to
    fewer shards instead of failing."""

    def __init__(self, n_devices: int, device=None):
        self.devices = shard_devices(max(1, int(n_devices)), resolve_device(device))
        self.n_devices = len(self.devices)
        self.shards = 1
        self.n_clients: int | None = None

    def bind(self, n_clients: int) -> "ServerMesh":
        """Fix the active shards for an ``n_clients`` batch."""
        self.shards = _largest_divisor_leq(n_clients, self.n_devices)
        self.n_clients = int(n_clients)
        return self

    def occupancy(self) -> list:
        """Clients per shard (uniform: the shard count divides the batch)."""
        if self.n_clients is None:
            return []
        return [self.n_clients // self.shards] * self.shards

    def spans(self) -> list:
        """The client span ``(lo, hi)`` of each active shard."""
        n = self.n_clients // self.shards
        return [(j * n, (j + 1) * n) for j in range(self.shards)]

    def _active_devices(self) -> tuple:
        return self.devices[:self.shards]

    # -- placement --------------------------------------------------------

    def split(self, x, dim: int = -1) -> Sharded:
        """``x`` client-axis sharded along ``dim``: a :class:`Sharded` (or a
        list, one part per shard) passes through; a tensor is cut into the
        bound spans, each part on its shard's device."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.shards:
                raise ValueError(f"{len(x)} parts for {self.shards} shards")
            return x if isinstance(x, Sharded) else Sharded(x, dim)
        return split_even(x, self._active_devices(), dim)

    def gather(self, parts) -> torch.Tensor:
        """The parts concatenated on the first shard's device: the
        degraded secure path's move of the packed share bits when the
        kernel stage binds a single shard (:meth:`kernel_bind` None).
        Values are untouched."""
        return torch.cat([p.to(self.devices[0]) for p in parts], dim=parts.dim)

    def shard_keys(self, leaves) -> list:
        """The five wire leaves of a key batch (host numpy, clients first)
        -> one ``IbDcfKeyBatch`` per shard, each on its shard's device."""
        return [ibdcf.keys_from_numpy(ibdcf.IbDcfKeyBatch(*(a[lo:hi] for a in leaves)), dev)
                for (lo, hi), dev in zip(self.spans(), self._active_devices())]

    def shard_frontier(self, frontier: collect.Frontier) -> list:
        """A plane-major frontier (the client axis last) -> one frontier
        per shard, each with its own copy of its clients' states and of
        the node mask: a restored checkpoint's (``tree_init`` builds each
        shard's root frontier from its own keys).  The crawl keeps the split
        from there on."""
        st = frontier.states
        out = []
        for (lo, hi), dev in zip(self.spans(), self._active_devices()):
            part = lambda a: a[..., lo:hi].to(dev).contiguous()
            out.append(collect.Frontier(
                states=EvalState(seed=part(st.seed), bit=part(st.bit), y_bit=part(st.y_bit)),
                alive=frontier.alive.to(dev).clone()))
        return out

    def gather_frontier(self, frontiers: list) -> collect.Frontier:
        """The per-shard frontiers as one, on the CPU (a checkpoint's)."""
        # fhh-lint: disable=chunked-device-readback (checkpoint gather: one host copy per shard, once per checkpoint, not per level)
        cat = lambda name: torch.cat([getattr(f.states, name).cpu() for f in frontiers], dim=-1)
        return collect.Frontier(states=EvalState(seed=cat("seed"), bit=cat("bit"),
                                                 y_bit=cat("y_bit")),
                                alive=frontiers[0].alive.cpu())

    def kernel_budget(self, requested: int) -> int:
        """Device budget of the secure kernel stage
        (``Config.secure_kernel_shards``): 0 follows the bound data shards;
        an explicit request is capped at them."""
        if requested <= 0:
            return self.shards
        return max(1, min(int(requested), self.shards))

    def kernel_bind(self, B: int, S: int, requested: int):
        """The row-sharded kernel stage of a ``B``-test level
        (``kernel_shard.KernelShard``), or None when only one shard fits:
        the caller then keeps the :meth:`gather` path.  Pure."""
        from . import kernel_shard

        return kernel_shard.bind(self._active_devices(), B, S, self.kernel_budget(requested))

    # -- the per-node reductions before the wire --------------------------

    def counts_by_pattern(self, packed_self, packed_peer, masks, alive_keys, alive_nodes):
        """Trusted per-node counts int64[F, 2^d] on the first shard's
        device: ``collect.counts_by_pattern`` per shard on its clients,
        then the sum over shards (exact)."""
        ps = self.split(packed_self, -1)
        pp = self.split(packed_peer, -1)
        ak = self.split(alive_keys, 0)
        dev0 = self.devices[0]
        total = None
        for a, b, k, dev in zip(ps, pp, ak, self._active_devices()):
            c = collect.counts_by_pattern(a, b, masks, k, alive_nodes.to(dev)).to(dev0)
            total = c if total is None else total + c
        return total
