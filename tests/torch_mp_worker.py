"""Two-process mesh worker of the port (launched by
``test_torch_mesh_multiprocess.py``): process p joins the gloo group, holds
mesh row p (2 × 4 logical CPU shards in all) and supplies only party p's
key batch (``MeshRunner.from_process_local``), crawls, and prints the heavy
hitters and what it holds as one JSON line.

    python tests/torch_mp_worker.py <pid> <coordinator host:port> <secure 0|1> [supervised]
    python tests/torch_mp_worker.py bin <bin.mesh arguments>

``supervised`` crawls with ``MeshLeader.run_supervised`` (a checkpoint
every 2 levels, the participant killed before level 3) and prints the
digests of the snapshots it took.  ``bin`` runs ``bin.mesh``'s ``main``
and prints what the process held when its crawl began.

It imports the port only, as a process on the card would."""

import gc
import hashlib
import json
import sys

import numpy as np
import torch

SUPERVISED_FAULTS = "mesh:kill@level=3"


def seed_rows(root_seed: torch.Tensor) -> set:
    """One 64-bit digest per 128-bit root seed of a key batch."""
    w = root_seed.contiguous().numpy().view(np.uint64).reshape(-1, 2)
    return set((w[:, 0] ^ (w[:, 1] * np.uint64(0x9E3779B97F4A7C15))).tolist())


def held_seed_rows() -> set:
    """The digests of every 16-byte window (at 4-byte steps) of the
    storage of every live tensor: a root seed held anywhere in this
    process, a view's base included, shows here."""
    out, seen = set(), set()
    for o in gc.get_objects():
        if not isinstance(o, torch.Tensor) or o.device.type != "cpu":
            continue
        st = o.untyped_storage()
        if st.data_ptr() in seen or st.nbytes() < 16:
            continue
        seen.add(st.data_ptr())
        raw = torch.empty(0, dtype=torch.uint8).set_(st).numpy()
        u32 = raw[:raw.size // 4 * 4].view(np.uint32).astype(np.uint64)
        lo = u32[:-3] | (u32[1:-2] << np.uint64(32))
        hi = u32[2:-1] | (u32[3:] << np.uint64(32))
        out.update((lo ^ (hi * np.uint64(0x9E3779B97F4A7C15))).tolist())
    return out


def key_holdings(prints: list, pid: int) -> dict:
    gc.collect()
    held = held_seed_rows()
    return {"own_keys_held": bool(held & prints[pid]),
            "peer_keys_held": bool(held & prints[1 - pid])}


def snapshot_digest(snap: dict) -> dict:
    return {f: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for f, a in sorted(snap.items())}


def scenario_keys():
    """tests/test_mesh_multiprocess.py's scenario: L = 6, d = 2, 32 clients."""
    from fuzzyheavyhitters_torch.ops import ibdcf
    from fuzzyheavyhitters_torch.utils import bits as bitutils

    rng = np.random.default_rng(7)
    L, d, n = 6, 2, 32
    centers = rng.integers(0, 1 << L, size=(3, d))
    pts = centers[rng.integers(0, 3, size=n)] + rng.integers(-1, 2, size=(n, d))
    pts = np.clip(pts, 0, (1 << L) - 1)
    bits = np.array([[bitutils.int_to_bits(L, int(v)) for v in row] for row in pts])
    return list(ibdcf.gen_l_inf_ball(bits, 2, rng, device="cpu")), n


def crawl(pid: int, coord: str, secure: bool, supervised: bool) -> None:
    from fuzzyheavyhitters_torch.parallel import mesh as meshmod
    from fuzzyheavyhitters_torch.resilience.chaos import MeshChaos, parse_mesh_faults

    meshmod.init_distributed(coord, 2, pid)
    keys, n = scenario_keys()  # on both processes; each keeps its own party's
    prints = [seed_rows(k.root_seed) for k in keys]
    my = keys[pid]
    del keys
    mesh = meshmod.make_mesh(devices=[torch.device("cpu")] * 8)
    runner = meshmod.MeshRunner.from_process_local(mesh, my, f_max=128,
                                                   secure_exchange=secure, min_bucket=8)
    del my
    holdings = key_holdings(prints, pid)
    lead = meshmod.MeshLeader(runner)
    snaps = []
    if supervised:
        take = runner.snapshot
        runner.snapshot = lambda: snaps.append(take()) or snaps[-1]
        res = lead.run_supervised(n, 0.1, checkpoint_every=2,
                                  chaos=MeshChaos(parse_mesh_faults(SUPERVISED_FAULTS)))
    else:
        res = lead.run(nreqs=n, threshold=0.1)
    out = {
        "pid": pid,
        "held_rows": list(runner.keys),
        **holdings,
        "bytes": [runner.link.bytes_sent, runner.link.bytes_received],
        "counters": lead.counters,
        "snapshots": [snapshot_digest(s) for s in snaps],
        "hitters": sorted([[int(v) for v in row] + [int(c)]
                           for row, c in zip(res.decode_ints(), res.counts)]),
    }
    print("RESULT " + json.dumps(out), flush=True)


def run_bin(argv: list) -> None:
    """``bin.mesh``'s main, with keygen's root seeds noted (as digests) and
    the process's tensors searched for them when the crawl begins."""
    from fuzzyheavyhitters_torch.bin import mesh as bin_mesh
    from fuzzyheavyhitters_torch.parallel import mesh as meshmod

    pid = int(argv[argv.index("--process_id") + 1])
    prints, holdings = [], {}
    gen = bin_mesh.ibdcf.gen_l_inf_ball

    def noted_gen(*a, **kw):
        keys = gen(*a, **kw)
        prints.extend(seed_rows(k.root_seed) for k in keys)
        return keys

    crawl_run = meshmod.MeshLeader.run

    def noted_run(self, *a, **kw):
        holdings.update(key_holdings(prints, pid))
        return crawl_run(self, *a, **kw)

    bin_mesh.ibdcf.gen_l_inf_ball = noted_gen
    meshmod.MeshLeader.run = noted_run
    bin_mesh.main(argv)
    print("HOLDINGS " + json.dumps(holdings), flush=True)


def main() -> None:
    if sys.argv[1] == "bin":
        run_bin(sys.argv[2:])
    else:
        crawl(int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1", "supervised" in sys.argv[4:])


if __name__ == "__main__":
    main()
