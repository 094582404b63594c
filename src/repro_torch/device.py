"""The port's device rule: the card by default, the CPU only on request."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → the CUDA device, which must exist; anything else as given.

    Entry points never fall back to the CPU on their own: a caller that
    wants the CPU (the parity tests) passes `device="cpu"`.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
