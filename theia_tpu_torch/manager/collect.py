"""Shared async single-flight collector for downloadable artifacts
(support bundles, profiler traces).

One state machine — none → collecting → collected | failed (with
errorMsg) — so every artifact endpoint speaks the same status
vocabulary and the CLI's poll-then-download client behaves identically
against all of them.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..utils import get_logger
from ..analysis.lockdep import named_lock

logger = get_logger("collect")


class AsyncCollector:
    """Subclasses implement `_collect(*args) -> bytes` (the artifact)
    and set `kind`; `create()` runs it on a daemon thread, single
    flight."""

    kind = "Artifact"
    api_version = "system.theia.antrea.io/v1alpha1"
    name = "theia-manager"

    def __init__(self) -> None:
        self.status = "none"
        self._data: Optional[bytes] = None
        self._error = ""
        self._lock = named_lock("manager.collect")

    def _collect(self, *args) -> bytes:
        raise NotImplementedError

    def create(self, *args) -> Dict[str, object]:
        with self._lock:
            already = self.status == "collecting"
            if not already:
                self.status = "collecting"
                self._error = ""
                self._data = None   # never serve a stale artifact as
                                    # if it were this collection
        if not already:
            threading.Thread(target=self._run, args=args,
                             daemon=True).start()
        return self.to_api()

    def _run(self, *args) -> None:
        try:
            data = self._collect(*args)
            with self._lock:
                self._data = data
                self.status = "collected"
        except Exception as e:
            with self._lock:
                self.status = "failed"
                self._error = f"{type(e).__name__}: {e}"
            logger.error("%s collection failed: %s", self.kind,
                         self._error)

    def _extra_status(self) -> Dict[str, object]:
        """Subclass hook for additional to_api fields (caller holds no
        lock; read only immutable/atomic attributes)."""
        return {}

    def to_api(self) -> Dict[str, object]:
        with self._lock:
            doc = {
                "kind": self.kind,
                "apiVersion": self.api_version,
                "metadata": {"name": self.name},
                "status": self.status,
                "size": len(self._data) if self._data else 0,
                "errorMsg": self._error,
            }
        doc.update(self._extra_status())
        return doc

    def data(self) -> Optional[bytes]:
        with self._lock:
            return self._data
