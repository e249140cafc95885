"""The port's device rule, shared by every function that allocates
device state: run where the caller says, default to the card, and
never run quietly on the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. CUDA unavailable raises unless the
    caller asked for the CPU; a bare "cuda" resolves to the current
    card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def auto_mesh(device):
    """What a job's mesh="auto" means on `device`: every visible card
    (parallel.job_mesh — None on a one-card host or under
    THEIA_MESH=off) when the job runs on a card, and one device when
    the caller asked for the CPU."""
    from ..parallel import job_mesh
    return job_mesh() if resolve_device(device).type == "cuda" else None
