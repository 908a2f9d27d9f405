"""Source-term physics in plain PyTorch (the reference chain)."""

import numpy as np
import torch


def const(a, like: torch.Tensor) -> torch.Tensor:
    """Host table (numpy/f64) as a tensor with ``like``'s dtype/device."""
    return torch.as_tensor(np.asarray(a, np.float64), dtype=like.dtype,
                           device=like.device)
