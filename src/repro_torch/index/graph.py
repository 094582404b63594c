"""Fixed-degree proximity-graph container (counterpart of `repro/index/graph.py`).

One dense int32 tensor `neighbors[N, R]` (padded with -1), on whatever
device built it. Fixed out-degree makes every traversal step a
static-shape gather + distance block. Index-axis sharding
(`ShardedGraphIndex`) waits for a later slice of the port.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GraphIndex:
    neighbors: torch.Tensor  # [N, R] int32, -1 padded
    entry_point: int         # medoid node id
    dim: int

    @property
    def n(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])

    def out_degrees(self) -> torch.Tensor:
        return (self.neighbors >= 0).sum(dim=1)

    def validate(self) -> None:
        """Structural invariants the traversal stack relies on.

        Raises TypeError/ValueError with actionable messages: an
        out-of-range id would scribble across the visited bitset and the
        gathers instead of failing.
        """
        nb = self.neighbors
        if nb.ndim != 2:
            raise ValueError(f"neighbors must be [N, R], got shape "
                             f"{tuple(nb.shape)}")
        n = nb.shape[0]
        if nb.dtype != torch.int32:
            raise TypeError(
                f"neighbors must be int32 (the gather/bitset index type), "
                f"got {nb.dtype}; cast with .to(torch.int32) after checking "
                "ids fit")
        mx = int(nb.max())
        if mx >= n:
            row = int(torch.argmax((nb.max(dim=1).values >= n).to(torch.int8)))
            raise ValueError(
                f"neighbor id {mx} out of range for N={n} nodes (first bad "
                f"row: {row})")
        mn = int(nb.min())
        if mn < -1:
            raise ValueError(
                f"neighbor id {mn} < -1 (only -1 marks an empty slot)")
        rows = torch.arange(n, device=nb.device, dtype=nb.dtype)[:, None]
        loops = ((nb == rows) & (nb >= 0)).any(dim=1)
        if bool(loops.any()):
            bad = int(torch.argmax(loops.to(torch.int8)))
            raise ValueError(
                f"self loop at node {bad} ({int(loops.sum())} total) — "
                "prune self edges before building an engine")
        if not 0 <= self.entry_point < n:
            raise ValueError(f"entry_point {self.entry_point} outside [0, {n})")
