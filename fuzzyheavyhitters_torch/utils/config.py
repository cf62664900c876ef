"""Config system — the port's own copy of the JSON schema.

Same fields and defaults as ``fuzzyheavyhitters_tpu/utils/config.py`` (the
reference schema of src/config.rs:5-16 plus the TPU package's knobs), so
every config file in ``configs/`` parses unchanged.  Fields this slice
does not use parse as before and are ignored.  Three options select paths
that are not ported yet; they raise ``NotImplementedError`` naming the
slice that brings them, instead of silently running the trusted crawl:

- ``secure_exchange: true``  — the GC/OT data plane (slice 2);
- ``crawl_radix_bits > 1``   — radix-2^k level fusion (slice 3);
- ``malicious: true``        — the sketch + MPC verification (slice 5).
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
        if self.secure_exchange:
            raise NotImplementedError(
                "secure_exchange: the GC/OT data plane is not ported yet "
                "(PyTorch port slice 2); run with secure_exchange=false"
            )
        if self.crawl_radix_bits != 1:
            raise NotImplementedError(
                f"crawl_radix_bits={self.crawl_radix_bits}: radix-2^k level "
                "fusion is not ported yet (PyTorch port slice 3)"
            )
        if self.malicious:
            raise NotImplementedError(
                "malicious: the sketch verification is not ported yet "
                "(PyTorch port slice 5)"
            )


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"Unknown config keys: {sorted(unknown)}")
    return Config(**raw)
