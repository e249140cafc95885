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


def single_device(mesh) -> None:
    """Only one device is ported: `mesh` "auto" and None both mean it;
    any other mesh raises rather than being ignored."""
    if mesh is None or (isinstance(mesh, str) and mesh == "auto"):
        return
    raise NotImplementedError(
        f"mesh {mesh!r}: running over several devices is not ported "
        "(ROADMAP A16); pass mesh='auto' or None for one device")
