"""The PyTorch port's collector fleet with the secure exchange (ot2s) on
the CPU, against the never-migrated run, tolerance zero (the flows of
``torch_fleet_flows.py``): a secure windowed collection live-migrated
mid-stream and failed over after a host kill.  The destination pair keys
its own channel after the import (a coin flip and a base OT a server, in
the JAX frame order), so a mixed pair matches only if the port's import
forces that re-key as the JAX server's does."""

import pytest
import torch

import torch_fleet_flows as F
from test_torch_fleet_rpc import MIXED, PORT, check_migrated


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_rekeyed(fig, key="default"):
    for st in fig["dest_status"]:
        row = st["sessions"]["per_session"][key]
        assert row["plane_epoch"] >= 1


@pytest.mark.parametrize("pairs,leader", [(PORT, "port"), (MIXED, "port"), (MIXED, "jax")],
                         ids=["port-pairs-port-leader", "mixed-pairs-port-leader",
                              "mixed-pairs-jax-leader"])
def test_secure_migration_mid_stream_bit_identical(tmp_path, pairs, leader):
    kw = F.cfg_kw("ot2s")
    results, fig = F.move_flow(tmp_path, *pairs, leader, kw, F.PLANS["two"], "migrate")
    assert results == F.control(kw, "two")
    check_migrated(fig, replayed=9)
    check_rekeyed(fig)


def test_secure_host_kill_failover_bit_identical(tmp_path):
    kw = F.cfg_kw("ot2s")
    results, fig = F.move_flow(tmp_path, *PORT, "port", kw, F.PLANS["two"], "failover")
    assert results == F.control(kw, "two")
    assert fig["stats"] == {"imported": True, "replayed": 9}
    check_rekeyed(fig)
