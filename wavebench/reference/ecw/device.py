"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The torch device asked for by name; ``None`` means the card
    (``cuda``).

    A CUDA device that is not present raises instead of degrading to
    the CPU: a run that asked for the card must run on it.  The CPU runs
    only when asked for by name, as the tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
