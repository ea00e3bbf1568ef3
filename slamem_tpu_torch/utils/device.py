"""Explicit device selection: the port never drops to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """``"cuda"``/``"cpu"`` (or a torch.device) -> torch.device.

    Raises if CUDA is asked for and no card is visible: a run that asked for
    the GPU and silently ran on the CPU would report the wrong device.
    ``"cuda"`` resolves to the current card's index (``cuda:0``), the
    device a tensor placed there reports, so the two compare equal.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
