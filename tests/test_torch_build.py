"""The hand-written kernels' launch protocol (theia_tpu_torch/ops/_build.py)
without a card: a fake library and a fake entry point stand in for the
built kernel, and a fake `torch.cuda` for the device and its stream.

`bind` checks each wrapper's constants against the library's before it
hands out the entry point; `launch` passes the stream last, raises on a
CUDA error code and counts a launch only when the code is 0;
`launches` reads the counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
from types import SimpleNamespace

import pytest

from theia_tpu_torch.ops import _build, dbscan, embed, fused_detector

#: the fake current stream's handle
STREAM = 0x5EED


@pytest.fixture
def fake_cuda(monkeypatch):
    """`_build` sees a card: entering a device records it, and the
    current stream is STREAM. Returns the devices entered."""
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    cuda = SimpleNamespace(
        device=device,
        current_stream=lambda: SimpleNamespace(cuda_stream=STREAM))
    monkeypatch.setattr(_build, "torch", SimpleNamespace(cuda=cuda))
    return entered


class FakeEntry:
    """A kernel entry point: records its calls, returns `err`."""

    def __init__(self, err: int = 0):
        self.err = err
        self.calls = []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


def fake_library(monkeypatch, constants, entries):
    """Make `_build.library` return a library that exports `constants`
    ((function, *args) → value) and the `entries` by name, and forget
    what was bound before."""
    table = {}
    for (fn, *args), value in constants.items():
        table.setdefault(fn, {})[tuple(args)] = value
    lib = SimpleNamespace(**entries, **{
        fn: (lambda *a, _t=values: _t[a]) for fn, values in table.items()})
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "_bound", {})
    return lib


#: each wrapper's library, entry point and constants
WRAPPERS = {
    "B1": ("stream_scan", "stream_scan_grouped_launch",
           fused_detector._ARGTYPES, fused_detector._CONSTANTS),
    "B2_one_launch": ("dbscan_noise", *dbscan._ENTRIES["one_launch"],
                      dbscan._CONSTANTS),
    "B2_two_pass": ("dbscan_noise", *dbscan._ENTRIES["two_pass"],
                    dbscan._CONSTANTS),
    "P1": ("points_pairs", "points_pairs", dbscan._PTS_ARGTYPES,
           dbscan._PTS_CONSTANTS),
    "E1": ("flow_embed", "flow_embed", embed._ARGTYPES, embed._CONSTANTS),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_bind_checks_the_constants_once_and_sets_the_abi(kernel,
                                                         monkeypatch):
    """A library with the wrapper's constants binds: the entry point
    takes the wrapper's arguments and then the stream, and returns an
    int; a second bind is the same function and asks nothing again."""
    name, entry, argtypes, constants = WRAPPERS[kernel]
    fn = FakeEntry()
    fake_library(monkeypatch, constants, {entry: fn})
    assert _build.bind(name, entry, argtypes, constants) is fn
    assert fn.argtypes == [*argtypes, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    monkeypatch.setattr(_build, "library", None)   # not asked again
    assert _build.bind(name, entry, argtypes, constants) is fn


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_bind_refuses_a_library_whose_constants_differ(kernel,
                                                       monkeypatch):
    """Each of the wrapper's constants, off by one in the library,
    raises at bind time and leaves the entry point unbound."""
    name, entry, argtypes, constants = WRAPPERS[kernel]
    for key in constants:
        fn = FakeEntry()
        fake_library(monkeypatch, {**constants, key: constants[key] + 1},
                     {entry: fn})
        with pytest.raises(RuntimeError, match=f"^{name}: the library's "
                           "constants .* differ from the wrapper's"):
            _build.bind(name, entry, argtypes, constants)
        assert fn.argtypes is None and not _build._bound


def test_a_zero_return_counts_one_launch_of_that_kernel(fake_cuda):
    """The entry point gets the arguments and then the device's current
    stream, on that device; its kernel's count moves by one and no
    other kernel's moves."""
    fn = FakeEntry()
    before = _build.launches()
    _build.launch("points_pairs", fn, "cuda:1", 11, 22.5, 33)
    after = _build.launches()
    assert fn.calls == [(11, 22.5, 33, STREAM)]
    assert fake_cuda == ["cuda:1"]
    assert after.get("points_pairs", 0) == before.get("points_pairs", 0) + 1
    assert {k: n for k, n in after.items() if k != "points_pairs"} == \
        {k: n for k, n in before.items() if k != "points_pairs"}


@pytest.mark.parametrize("err", [1, 700, -1])
def test_a_cuda_error_raises_with_the_kernel_and_is_not_counted(fake_cuda,
                                                                err):
    fn = FakeEntry(err)
    before = _build.launches()
    with pytest.raises(RuntimeError, match=f"^dbscan_noise kernel launch "
                       f"failed: CUDA error {err}$"):
        _build.launch("dbscan_noise", fn, "cuda:0", 1, 2)
    assert len(fn.calls) == 1
    assert _build.launches() == before


def test_launches_is_a_copy():
    counts = _build.launches()
    counts["stream_scan"] = -5
    assert _build.launches().get("stream_scan", 0) >= 0


def test_no_launch_is_lost_under_contention(fake_cuda):
    """Threads launching at once, with the interpreter switching often:
    every launch is counted."""
    threads, each = 16, 200
    fn = FakeEntry()
    before = _build.launches().get("stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [_build.launch("stress", fn, "cuda:0")
                            for _ in range(each)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert _build.launches()["stress"] - before == threads * each
