"""Sorted-buffer helpers: payload packing and the plain stable top-m merge.

Counterpart of `repro/kernels/topk.py`'s `pack_payload`/`unpack_payload`
and of the order its host merge (`bitonic_merge_sorted`, position lane)
and the dense backend's stable argsort both give: entries ordered by
(distance, position in `[old | new]`). The fused kernel (K1) sorts on the
same pair, so all three agree on ties.
"""
from __future__ import annotations

import torch


def pack_payload(idx: torch.Tensor, expanded: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """node id (< 2^29) + expanded/valid flags into one non-negative int32."""
    p = (idx | (expanded.to(torch.int32) << 29)
         | (valid.to(torch.int32) << 30))
    return torch.where(idx < 0, -1, p).to(torch.int32)


def unpack_payload(p: torch.Tensor):
    neg = p < 0
    idx = torch.where(neg, -1, p & ((1 << 29) - 1)).to(torch.int32)
    expanded = ~neg & (((p >> 29) & 1) != 0)
    valid = ~neg & (((p >> 30) & 1) != 0)
    return idx, expanded, valid


def merge_stable(dist: torch.Tensor, lanes: tuple, new_dist: torch.Tensor,
                 new_lanes: tuple, m: int):
    """Merge sorted [B, M0] (dist + value lanes) with raw [B, R] entries and
    keep the best m, in stable-argsort order over `[old | new]`.

    Returns (dist [B, m], tuple of lanes [B, m]).
    """
    d = torch.cat([dist, new_dist], dim=1)
    order = torch.argsort(d, dim=1, stable=True)[:, :m]
    out = tuple(torch.gather(torch.cat([a, b], dim=1), 1, order)
                for a, b in zip(lanes, new_lanes))
    return torch.gather(d, 1, order), out
