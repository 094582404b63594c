"""The one squared-L2 expression of the port (counterpart of
`repro/kernels/distance.py::sqdist_bdrd`)."""
from __future__ import annotations

import torch


def sqdist_bdrd(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q [B, d], x [B, R, d] -> [B, R] squared L2, clamped >= 0.

    `init_state`, the dense backend and the fused kernel's plain version
    all call this, so a numerics change cannot desynchronize them.
    """
    q = q.to(torch.float32)
    x = x.to(torch.float32)
    qn = (q * q).sum(dim=-1)[:, None]
    xn = (x * x).sum(dim=-1)
    qx = torch.einsum("bd,brd->br", q, x)
    return torch.clamp(qn + xn - 2.0 * qx, min=0.0)
