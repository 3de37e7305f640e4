"""Device selection: the card by default, the CPU only when asked for.

Every entry point that creates state (`JasperIndex`, `init_core`,
`core_from_arrays`, ...) resolves its `device` argument here. There is no
fallback: with no GPU and no explicit `device="cpu"` the call raises.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the CUDA card (raises without one); "cpu"/"cuda[:n]" as
    given. Any other device type is refused."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run on "
                "the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def on_device(device):
    """A context with `device` current when it is a card (the CUDA runtime
    launches on, and sets kernel attributes for, the current device); a
    no-op on the CPU."""
    dev = torch.device(device)
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def synchronize(device) -> None:
    """Wait for the card's queued work when `device` is a card; a no-op on
    the CPU (where every op has finished when it returns)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
