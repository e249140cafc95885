"""The spatial anomaly job's flow embedding on the job's device.

`flow_embedding(src, dst, port, octets)` turns the four store columns
the job reads (analytics/spatial.py SPATIAL_COLUMNS: the sourceIP and
destinationIP dictionary codes and destinationTransportPort as int32,
octetDeltaCount as int64) into the [n, 7] float32 embedding that
`analytics.spatial.flow_embeddings` computes in numpy on the host: two
hash coordinates in [0, 100) for each of source, destination and port,
then log1p of the bytes. CUDA tensors take the hand-written kernel
csrc/flow_embed.cu, one launch, bound and launched through `_build`
(counted under `flow_embed`); CPU tensors take the plain version,
`_embed_torch`, the numpy code's arithmetic step for step in int64 and
float64 torch ops. On either device the inputs are checked first
(`_check`); there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the embedding's width, the categorical axes' range, and each
#: identity's two hash seeds (the numpy code's literals, checked against
#: the kernel's when it loads)
EMBED_DIM = 7
SCALE = 100
SEEDS = (0x1234ABCD, 0x9E3779B9)
#: each column's dtype as the store holds it
DTYPES = (torch.int32, torch.int32, torch.int32, torch.int64)
_NAMES = ("src", "dst", "port", "octets")

_MASK32 = 0xFFFFFFFF
_PTR = ctypes.c_void_p
_ARGTYPES = [_PTR, _PTR, _PTR, _PTR, ctypes.c_longlong, _PTR]
_CONSTANTS = {("flow_embed_dim",): EMBED_DIM,
              ("flow_embed_scale",): SCALE,
              **{("flow_embed_seed", i): ctypes.c_int(s).value
                 for i, s in enumerate(SEEDS)}}


def route(device: torch.device) -> str:
    """"kernel" on a CUDA device, "torch" (the plain version) on the
    CPU; any other device raises."""
    if device.type == "cuda":
        return "kernel"
    if device.type == "cpu":
        return "torch"
    raise ValueError(f"flow_embed: no route for {device}")


def _check(cols) -> None:
    """Raise ValueError for columns the embedding does not take: each
    1-D and contiguous in its `DTYPES` dtype, all of one length on one
    device."""
    for name, col, dtype in zip(_NAMES, cols, DTYPES):
        if col.dtype != dtype:
            raise ValueError(f"flow_embed: {name} must be {dtype}, got "
                             f"{col.dtype}")
        if col.dim() != 1:
            raise ValueError(f"flow_embed: {name} must be 1-D, got "
                             f"{tuple(col.shape)}")
        if not col.is_contiguous():
            raise ValueError(f"flow_embed: {name} must be contiguous")
    if len({len(c) for c in cols}) != 1:
        raise ValueError("flow_embed: the columns' lengths differ: "
                         f"{[len(c) for c in cols]}")
    if len({c.device for c in cols}) != 1:
        raise ValueError("flow_embed: the columns must lie on one device, "
                         f"got {[str(c.device) for c in cols]}")


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2³² for int64 h in [0, 2³²) and m < 2³², with no
    int64 product above 2⁴⁸: m in two 16-bit halves."""
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (hi + h * (m & 0xFFFF)) & _MASK32


def _hash01(codes: torch.Tensor, seed: int) -> torch.Tensor:
    """The numpy code's `_hash01` in int64 ops: codes read as uint32
    (their low 32 bits), float64 in [0, 1)."""
    h = (codes.long() & _MASK32) ^ seed
    h ^= h >> 16
    h = _mul32(h, 0x85EBCA6B)
    h ^= h >> 13
    h = _mul32(h, 0xC2B2AE35)
    h ^= h >> 16
    return h.double() / 4294967296.0


def _embed_torch(src, dst, port, octets) -> torch.Tensor:
    """The plain version, on the columns' device."""
    axes = [_hash01(codes, seed) * float(SCALE)
            for codes in (src, dst, port) for seed in SEEDS]
    axes.append(torch.log1p(octets.double()))
    return torch.stack(axes, dim=1).float()


def _embed_kernel(src, dst, port, octets) -> torch.Tensor:
    """One launch of csrc/flow_embed.cu."""
    n = len(src)
    out = torch.empty((n, EMBED_DIM), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    fn = _build.bind("flow_embed", "flow_embed", _ARGTYPES, _CONSTANTS)
    _build.launch("flow_embed", fn, src.device, src.data_ptr(),
                  dst.data_ptr(), port.data_ptr(), octets.data_ptr(), n,
                  out.data_ptr())
    return out


_EMBED = {"kernel": _embed_kernel, "torch": _embed_torch}


def flow_embedding(src: torch.Tensor, dst: torch.Tensor, port: torch.Tensor,
                   octets: torch.Tensor) -> torch.Tensor:
    """[n, 7] float32 embedding (src×2, dst×2, port×2, log1p bytes) of
    n flows' columns, on their device: the kernel on a card, the plain
    version on the CPU. Raises ValueError for columns `_check`
    refuses."""
    cols = (src, dst, port, octets)
    _check(cols)
    return _EMBED[route(src.device)](*cols)
