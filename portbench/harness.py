"""The benchmark's core: finds the parts of a cell by name, runs the
port's manager as a child process, reads its counters and traces, and
prints the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(`configs/<file>`, the manager's flags and environment and the
cluster's sizes) and a traffic mix (`traffic/<traffic>.json`, data read
by the traffic kind `traffic/<kind>.py`). A per-layer metric is read by
`metrics/<name>.py`. A later cell, mix, kind or metric is a new file.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import http.client
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

PB = Path(__file__).resolve().parent
ROOT = PB.parent
#: modules that no process of the benchmark may hold (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "theia_tpu")
#: build and kernel caches of the program, at fixed paths in the checkout
CACHE_DIR = ROOT / ".portbench_cache"
READY_S = 300.0


# -- finding the parts of a cell ----------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module from a file of the benchmark (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic
    mix read from their files."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT) -> None:
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.bench = bench
        self.workload = by_name[name]
        self.name = name
        cfg = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = json.loads((root / cfg["file"]).read_text())
        self.traffic = json.loads(
            (PB / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.chips = int(self.workload["chips"])

    def kind(self):
        return load_module(PB / "traffic" / f"{self.traffic['kind']}.py")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def with_held(bench: dict) -> dict:
    """BENCHMARK.json with the cells held out of it (`held/<cell>.json`:
    a cell's workload and the metrics that only it reports), which its
    tests still run."""
    out = {k: list(v) if isinstance(v, list) else v
           for k, v in bench.items()}
    for path in sorted((PB / "held").glob("*.json")):
        doc = json.loads(path.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            out[key] = out[key] + doc.get(key, [])
    return out


def metric_reader(name: str):
    return load_module(PB / "metrics" / f"{name}.py")


# -- statistics ---------------------------------------------------------

def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, nearest rank."""
    v = np.sort(np.asarray(values, np.float64))
    if not len(v):
        raise ValueError("percentile of no values")
    rank = max(1, int(np.ceil(q / 100.0 * len(v))))
    return float(v[rank - 1])


def prom_parse(text: str) -> Dict[Tuple[str, Tuple], float]:
    """Prometheus text exposition → {(name, ((label, value), ...)): v}."""
    out: Dict[Tuple[str, Tuple], float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = []
            for part in _split_labels(rest.rstrip("}")):
                k, _, v = part.partition("=")
                labels.append((k.strip(), v.strip().strip('"')))
            key = (name, tuple(sorted(labels)))
        else:
            key = (head.strip(), ())
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


def _split_labels(s: str) -> List[str]:
    parts, cur, quoted = [], [], False
    for ch in s:
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return [p for p in parts if p.strip()]


def prom_mean_delta(before: dict, after: dict, name: str,
                    **labels) -> Optional[float]:
    """Δ`<name>_sum` / Δ`<name>_count` of one histogram series between
    two scrapes; None when no observation fell between them."""
    key = tuple(sorted(labels.items()))
    d_count = (after.get((f"{name}_count", key), 0.0)
               - before.get((f"{name}_count", key), 0.0))
    if d_count <= 0:
        return None
    d_sum = (after.get((f"{name}_sum", key), 0.0)
             - before.get((f"{name}_sum", key), 0.0))
    return d_sum / d_count


# -- the device trace ---------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_events(trace: dict) -> List[Tuple[float, float, str]]:
    """(start µs, end µs, name) of every operation that ran on the card."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   str(e.get("name", "")))
                  for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)


def union(intervals, lo: float = -np.inf,
          hi: float = np.inf) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], merged."""
    merged: List[List[float]] = []
    for s, e, *_ in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_us(intervals, lo: float = -np.inf, hi: float = np.inf) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))


def breakdown(trace: dict, lo: float, hi: float) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the card in [lo, hi] named by the host operation that
    overlapped each gap most."""
    dev = [d for d in trace_device_events(trace) if d[1] > lo and d[0] < hi]
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = union(dev, lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   str(e.get("name", "")))
                  for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in (
                      "cpu_op", "python_function", "user_annotation",
                      "cuda_runtime", "cuda_driver"))
    named = []
    for gs, ge in gaps:
        best, best_ov = "no traced host operation", 0.0
        for s, e, n in host:
            if s >= ge:
                break
            ov = min(e, ge) - max(s, gs)
            if ov > best_ov:
                best, best_ov = n, ov
        named.append([best, (ge - gs) / 1e6])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": named}


# -- the manager, a child process ---------------------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class HttpError(RuntimeError):
    def __init__(self, status: int, body: bytes) -> None:
        super().__init__(f"HTTP {status}: {body[:300]!r}")
        self.status = status
        self.body = body


class Manager:
    """`python -m theia_tpu_torch.manager` as a child process, with the
    configuration's flags and environment, its WAL and parts under a
    directory of its own; the harness drives it over HTTP."""

    def __init__(self, config: dict, workdir: str, device: str = "cuda",
                 command: Optional[List[str]] = None) -> None:
        self.config = config
        self.workdir = workdir
        self.device = device
        self.port = free_port()
        self.command = command or [sys.executable, "-m",
                                   "theia_tpu_torch.manager"]
        self.log_path = os.path.join(workdir, "manager.log")
        self.proc: Optional[subprocess.Popen] = None
        self._local = threading.local()

    def start(self) -> None:
        mgr = self.config["manager"]
        env = dict(os.environ)
        env.update({k: str(v) for k, v in mgr.get("env", {}).items()})
        env["THEIA_STORE_COLD_DIR"] = os.path.join(self.workdir, "parts")
        env["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
        env["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        args = [*self.command, "--device", self.device,
                "--port", str(self.port),
                "--wal-dir", os.path.join(self.workdir, "wal"),
                *[str(a) for a in mgr.get("args", [])]]
        self._log = open(self.log_path, "wb")
        self.proc = subprocess.Popen(args, cwd=str(ROOT), env=env,
                                     stdin=subprocess.DEVNULL,
                                     stdout=self._log,
                                     stderr=subprocess.STDOUT)

    def wait_ready(self, timeout: float = READY_S) -> dict:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"the manager exited with {self.proc.returncode} "
                    f"before it served:\n{self.log_tail()}")
            try:
                return self.get_json("/healthz", timeout=5)
            except (OSError, HttpError, http.client.HTTPException):
                self._drop_conn()
                time.sleep(0.1)
        raise TimeoutError(f"the manager did not serve within "
                           f"{timeout:.0f}s:\n{self.log_tail()}")

    def _conn(self, timeout: float) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                              timeout=timeout)
            self._local.conn = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                ctype: str = "application/json",
                timeout: float = 300.0) -> Tuple[int, bytes]:
        """One request on this thread's keep-alive connection."""
        for attempt in (0, 1):
            conn = self._conn(timeout)
            try:
                headers = {"Content-Type": ctype} if body is not None else {}
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.RemoteDisconnected, BrokenPipeError,
                    ConnectionResetError):
                # a keep-alive connection the server closed: open anew
                self._drop_conn()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def get_json(self, path: str, timeout: float = 300.0):
        status, raw = self.request("GET", path, timeout=timeout)
        if status != 200:
            raise HttpError(status, raw)
        return json.loads(raw)

    def send_json(self, method: str, path: str, doc,
                  timeout: float = 300.0):
        status, raw = self.request(method, path,
                                   json.dumps(doc).encode(),
                                   timeout=timeout)
        if status not in (200, 201):
            raise HttpError(status, raw)
        return json.loads(raw)

    def scrape(self) -> dict:
        status, raw = self.request("GET", "/metrics")
        if status != 200:
            raise HttpError(status, raw)
        return prom_parse(raw.decode())

    def memory_in_use(self) -> Optional[int]:
        """Device memory in use (the CUDA context and what the caching
        allocator holds, which it never gives back: the run's peak)."""
        doc = self.get_json("/apis/stats.theia.antrea.io/v1alpha1/"
                            "clickhouse/deviceInfo")
        info = doc.get("deviceInfos") or [{}]
        v = info[0].get("memoryBytesInUse")
        return int(v) if v is not None else None

    def device_kind(self) -> Optional[str]:
        doc = self.get_json("/apis/stats.theia.antrea.io/v1alpha1/"
                            "clickhouse/deviceInfo")
        return (doc.get("deviceInfos") or [{}])[0].get("deviceKind")

    def profile(self, seconds: float, timeout: float = 180.0) -> dict:
        """A torch.profiler capture of `seconds` in the manager, through
        its profile endpoint; the Chrome trace as a dict."""
        path = "/apis/system.theia.antrea.io/v1alpha1/profiles"
        self.send_json("POST", path, {"durationSeconds": seconds})
        return self.profile_result(timeout)

    def profile_result(self, timeout: float = 180.0) -> dict:
        path = "/apis/system.theia.antrea.io/v1alpha1/profiles"
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            doc = self.get_json(path)
            if doc["status"] == "failed":
                raise RuntimeError(f"profile failed: {doc['errorMsg']}")
            if doc["status"] == "collected":
                break
            time.sleep(0.05)
        else:
            raise TimeoutError("the profile was not collected")
        status, raw = self.request("GET", f"{path}/theia-manager/download")
        if status != 200:
            raise HttpError(status, raw)
        with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
            member = next(m for m in tar.getmembers()
                          if m.name.endswith(".json"))
            return json.load(tar.extractfile(member))

    def log_tail(self, n: int = 4000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, timeout: float = 120.0) -> Optional[int]:
        """SIGTERM, as an operator stops it (it drains and fsyncs the
        WAL); SIGKILL if it has not ended within `timeout`. Waits."""
        self._drop_conn()
        if self.proc is None:
            return None
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._log.close()
        return self.proc.returncode


# -- the run ------------------------------------------------------------

class Ctx:
    """What a traffic kind, a reference and a metric reader share."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, workdir: str) -> None:
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.workdir = workdir
        self.mgr: Optional[Manager] = None
        self.prom0: dict = {}
        self.prom1: dict = {}
        #: the device trace of the traced run and its span (µs)
        self.trace_doc: Optional[dict] = None
        self.trace_span: Optional[Tuple[float, float]] = None
        #: end-to-end metrics the kind measured
        self.e2e: Dict[str, float] = {}
        #: anything else a kind keeps for its references and readers
        self.data: Dict[str, object] = {}
        self.notes: Dict[str, object] = {}


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def note(**fields) -> None:
    """A line for the reader of the run (standard error)."""
    print(json.dumps(fields, default=str), file=sys.stderr, flush=True)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run(name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda",
        manager_command: Optional[List[str]] = None,
        root: Path = ROOT, config: Optional[dict] = None,
        traffic: Optional[dict] = None,
        bench: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line's object. Raises when
    the run cannot produce a result. `config` replaces keys of the
    configuration's groups (`{"cluster": {...}}`) and `traffic` keys
    of the traffic mix (the tests' small sizes); `bench` stands for
    BENCHMARK.json (the tests' cells held out of it, `held/`)."""
    cell = Cell(bench or load_benchmark(root), name, root)
    for group, keys in (config or {}).items():
        cell.config[group].update(keys)
    cell.traffic.update(traffic or {})
    kind = cell.kind()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    ctx = Ctx(cell, seed, seconds, trace, device, workdir)
    mgr = ctx.mgr = Manager(cell.config, workdir, device, manager_command)
    peak = None
    try:
        mgr.start()
        kind.prepare(ctx)          # the traffic, while the manager starts
        mgr.wait_ready()
        kind.setup(ctx)
        if trace:
            mgr.profile(0.2)       # the profiler's first start, untimed
        peak = mgr.memory_in_use()
        ctx.prom0 = mgr.scrape()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        kind.window(ctx)
        ctx.prom1 = mgr.scrape()
        used = mgr.memory_in_use()
        peak = max(filter(None, [peak, used]), default=None)
        kind.collect(ctx)
        kind_name = mgr.device_kind() or device
    finally:
        rc = mgr.stop()
        try:
            kind.cleanup(ctx)
        finally:
            _rmtree(workdir)
    if rc not in (0, None):
        note(manager_exit=rc, tail=mgr.log_tail(1500))
    checks = kind.check(ctx)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics: Dict[str, dict] = {}
    if not trace:
        e2e = {**ctx.e2e, "setup_s": setup_s}
        for m in cell.end_to_end():
            if m["name"] not in e2e:
                raise RuntimeError(f"the cell measured no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer():
            v = metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": ctx.data["attempted"],
           "failed": ctx.data["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if device == "cuda" else device,
                      "kind": kind_name, "count": cell.chips,
                      "memory_peak_bytes": peak,
                      "power": power_limit() if device == "cuda" else None}}
    if trace and ctx.trace_doc is not None:
        lo, hi = ctx.trace_span
        dev = trace_device_events(ctx.trace_doc)
        out["device"]["busy_s"] = busy_us(dev, lo, hi) / 1e6
        out["device"]["window_s"] = (hi - lo) / 1e6
        out["breakdown"] = breakdown(ctx.trace_doc, lo, hi)
    out["checks"] = checks
    return out


def _rmtree(path: str) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)
