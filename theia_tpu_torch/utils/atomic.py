"""Atomic file publication: write to a same-directory temp file, then
os.replace onto the destination. A reader (or a crash) at any moment
sees either the old complete file or the new complete file, never a
torn one. Shared by the store snapshot path, the checkpointer, and the
runner's progress file.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable


def atomic_write(path: str, write_fn: Callable[[str], None],
                 suffix: str = "") -> None:
    """Run `write_fn(tmp_path)` then atomically publish tmp as `path`.

    `suffix` matters when the writer appends one itself (np.savez adds
    .npz to names without it — pass suffix=".npz" so the temp name
    already carries it and the replace source exists).
    """
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=suffix)
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
