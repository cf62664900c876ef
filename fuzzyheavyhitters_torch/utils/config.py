"""Config system — the port's own copy of the JSON schema.

Same fields and defaults as ``fuzzyheavyhitters_tpu/utils/config.py`` (the
reference schema of src/config.rs:5-16 plus the JAX package's knobs), so
every config file in ``configs/`` parses unchanged.  ``debug_guards: true``
arms the lock-discipline sanitizer (``utils/guards.py``) on every server,
collection session and windowed ingest built from the config, whatever
``FHH_DEBUG_GUARDS`` says.  The ``ingest_*`` fields
configure the streaming front door (``resilience/admission.py``).
``secure_exchange: true`` runs the GC/OT data plane, with ``ot_path``
("auto", "ot2s" or "gc") choosing its equality engine.  ``crawl_radix_bits`` (1, 2 or 3) fuses that
many bit levels per crawl round; where it is used, ``collect.check_radix``
holds it against ``n_dims``.  ``malicious: true`` runs the sketch + MPC
verification (``protocol/sketch.py``) on the socket deployment.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class Config:
    data_len: int
    n_dims: int
    ball_size: int
    addkey_batch_size: int
    num_sites: int
    threshold: float
    zipf_exponent: float
    server0: str
    server1: str
    distribution: str
    sketch_batch_size: int = 100_000
    sketch_batch_size_last: int = 25_000
    backend: str = "tpu"
    secure_exchange: bool = False
    malicious: bool = False
    f_max: int = 1024  # frontier capacity: survivors beyond it raise
    crawl_shard_nodes: int = 0
    crawl_pipeline_depth: int = 1
    crawl_radix_bits: int = 1
    ot_path: str = "auto"
    secure_whole_level: bool = True
    server_data_devices: int = 0
    secure_kernel_shards: int = 0
    sketch_shards: int = 0
    secure_phase_sync: bool = True
    ingest_window_keys: int = 1 << 20
    ingest_rate_keys_per_s: float = 0.0
    ingest_burst_keys: int = 4096
    ingest_client_quota: int = 0
    ingest_shed: str = "reject"
    ingest_seed: int = 0
    ingest_windows_retained: int = 4
    collection_sessions_max: int = 8
    debug_guards: bool = False

    def __post_init__(self):
        if self.ot_path not in ("auto", "ot2s", "gc"):
            raise ValueError(f"ot_path must be auto, ot2s or gc, got {self.ot_path!r}")


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"Unknown config keys: {sorted(unknown)}")
    return Config(**raw)

