"""Port-forward into the cluster for the CLI.

The reference CLI tunnels to the manager Service with a client-go
SPDY port-forwarder (pkg/theia/portforwarder/portforwarder.go:48,74)
unless --use-cluster-ip is set. The equivalent here delegates to
`kubectl port-forward` — the operator's kubeconfig and auth are
exactly what kubectl already handles — and parses the bound local
port from its output. The CLI owns the child for the duration of the
command and tears it down on exit.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Optional

API_PORT = 11347
START_TIMEOUT_SECONDS = 20.0


class PortForwardError(SystemExit):
    pass


class PortForwarder:
    """One `kubectl port-forward svc/<service> :11347` child."""

    def __init__(self, namespace: str, service: str = "theia-manager",
                 kubectl: str = "kubectl") -> None:
        self.namespace = namespace
        self.service = service
        self.kubectl = kubectl
        self.local_port: Optional[int] = None
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> int:
        """Spawn the forwarder; returns the local port once kubectl
        reports `Forwarding from 127.0.0.1:<port> -> ...`."""
        cmd = [self.kubectl, "-n", self.namespace, "port-forward",
               f"svc/{self.service}", f":{API_PORT}"]
        try:
            self._proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError:
            raise PortForwardError(
                f"error: --use-port-forward needs {self.kubectl!r} on "
                f"PATH (or pass --kubectl); alternatively reach the "
                f"manager directly with --manager-addr")

        port: list = []
        output: list = []   # kubectl's own words for the error path

        def read():
            assert self._proc and self._proc.stdout
            for line in self._proc.stdout:
                if line.strip():
                    output.append(line.strip())
                if not port and "Forwarding from" in line:
                    try:
                        # "Forwarding from 127.0.0.1:40123 -> 11347"
                        addr = line.split("Forwarding from", 1)[1]
                        port.append(int(
                            addr.split("->")[0].strip()
                            .rsplit(":", 1)[1]))
                    except (IndexError, ValueError):
                        pass
                    done.set()
            done.set()   # EOF: kubectl exited

        done = threading.Event()
        t = threading.Thread(target=read, daemon=True)
        t.start()
        if not done.wait(START_TIMEOUT_SECONDS) or not port:
            rc = self._proc.poll()
            self.stop()
            tail = " | ".join(output[-3:])
            raise PortForwardError(
                "error: port-forward did not come up"
                + (f" (kubectl exited {rc})" if rc is not None else "")
                + (f": {tail}" if tail else ""))
        self.local_port = port[0]
        return self.local_port

    def stop(self) -> None:
        if self._proc and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        self._proc = None
