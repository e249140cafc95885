"""The port's device-facing manager pieces on the CPU: the
`deviceInfo` stats component (torch.cuda in place of jax.devices())
and the profiler capture (torch.profiler in place of jax.profiler),
against the reference's shapes."""

from __future__ import annotations

import io
import json
import tarfile
import time
import types

import jax
import pytest
import torch

from theia_tpu.cli.__main__ import main as ref_cli_main
from theia_tpu.manager.stats import StatsProvider as RefStats
from theia_tpu.store import FlowDatabase as RefDatabase
from theia_tpu_torch.cli.__main__ import main as port_cli_main
from theia_tpu_torch.manager import TheiaManagerServer
from theia_tpu_torch.manager.profiling import ProfileManager
from theia_tpu_torch.manager.stats import StatsProvider
from theia_tpu_torch.store import FlowDatabase
from test_torch_analysis import port_lockdep_clean  # noqa: F401


def test_device_info_on_the_cpu_is_the_no_backend_entry(monkeypatch):
    """A manager on the CPU answers as the reference does when no
    backend is usable: one entry with the shard and an error."""
    def no_backend():
        raise RuntimeError("no backend")

    monkeypatch.setattr(jax, "devices", no_backend)
    want = RefStats(RefDatabase()).device_infos()
    got = StatsProvider(FlowDatabase(), device="cpu").device_infos()
    assert [sorted(d) for d in got] == [sorted(d) for d in want] == \
        [["error", "shard"]]
    assert "cpu" in got[0]["error"]


def test_device_info_reads_the_card(monkeypatch):
    """On a card: its name, total memory, what mem_get_info finds in
    use, and this process's allocated bytes, with the reference's
    per-device keys."""
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda i: types.SimpleNamespace(name="NVIDIA H100 80GB HBM3"))
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (60 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 4096)
    got = StatsProvider(FlowDatabase(), device="cuda").device_infos()
    assert got == [{
        "shard": "0", "deviceId": "0", "platform": "gpu",
        "deviceKind": "NVIDIA H100 80GB HBM3", "processIndex": "0",
        "memoryBytesInUse": str(20 * gib),
        "memoryBytesLimit": str(80 * gib),
        "memoryUsedPercentage": "25.00",
        "memoryBytesAllocated": "4096"}]


def _wait_collected(pm, seconds=60.0):
    deadline = time.time() + seconds
    while pm.status == "collecting" and time.time() < deadline:
        time.sleep(0.05)
    assert pm.status == "collected", pm.to_api()


def test_profile_capture_is_a_chrome_trace():
    pm = ProfileManager(device="cpu")
    doc = pm.create(duration_seconds=0.2)
    assert doc["status"] == "collecting"
    assert doc["durationSeconds"] == 0.2
    _wait_collected(pm)
    tar = tarfile.open(fileobj=io.BytesIO(pm.data()), mode="r:gz")
    assert tar.getnames() == ["trace.json"]
    trace = json.load(tar.extractfile("trace.json"))
    assert "traceEvents" in trace


@pytest.mark.parametrize("cli_main", (port_cli_main, ref_cli_main),
                         ids=("port-cli", "reference-cli"))
def test_profile_cli_against_a_port_manager(cli_main, tmp_path, capsys):
    """`theia profile` drives the port manager's capture end to end:
    the port's CLI, and the reference's (JAX-free, over HTTP) as the
    wire-compatibility case."""
    srv = TheiaManagerServer(FlowDatabase(), port=0, ingest_shards=1,
                             device="cpu")
    srv.start_background()
    try:
        out = tmp_path / "prof.tar.gz"
        cli_main(["--manager-addr", f"http://127.0.0.1:{srv.port}",
                  "profile", "-d", "0.3", "-f", str(out)])
        assert str(out) in capsys.readouterr().out
        with tarfile.open(out, mode="r:gz") as tar:
            assert tar.getnames() == ["trace.json"]
    finally:
        srv.shutdown()
