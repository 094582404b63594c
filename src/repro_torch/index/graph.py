"""Fixed-degree proximity-graph container (counterpart of `repro/index/graph.py`).

One dense int32 tensor `neighbors[N, R]` (padded with -1), on whatever
device built it. Fixed out-degree makes every traversal step a
static-shape gather + distance block.

For index-axis sharding (`core/sharded.py`), `ShardedGraphIndex` holds one
independent `GraphIndex` per contiguous corpus slice. Each shard graph uses
shard-local node ids in [0, n_s) — edges never cross slices — and carries
its slice coordinates (`shard`, `offset`), so a validation error names the
offending shard instead of surfacing later as a bad gather.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class GraphIndex:
    neighbors: torch.Tensor  # [N, R] int32, -1 padded, shard-local ids
    entry_point: int         # medoid node id (shard-local)
    dim: int
    shard: int | None = None  # shard ordinal in a ShardedGraphIndex
    offset: int = 0           # global row id of local row 0 (slice start)

    @property
    def n(self) -> int:
        return int(self.neighbors.shape[0])

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])

    def out_degrees(self) -> torch.Tensor:
        return (self.neighbors >= 0).sum(dim=1)

    def _where(self) -> str:
        """Locator suffix for error messages: which shard/slice is bad."""
        if self.shard is None:
            return ""
        return (f" (shard {self.shard}, global rows "
                f"[{self.offset}, {self.offset + self.n}))")

    def validate(self) -> None:
        """Structural invariants the traversal stack relies on.

        Raises TypeError/ValueError with actionable messages: an
        out-of-range id would scribble across the visited bitset and the
        gathers instead of failing. For a shard graph every message
        carries the shard and its slice: an id ≥ n_s but < N is a
        cross-shard edge, valid globally and fatal locally.
        """
        nb = self.neighbors
        if nb.ndim != 2:
            raise ValueError(f"neighbors must be [N, R], got shape "
                             f"{tuple(nb.shape)}{self._where()}")
        n = nb.shape[0]
        if nb.dtype != torch.int32:
            raise TypeError(
                f"neighbors must be int32 (the gather/bitset index type), "
                f"got {nb.dtype}{self._where()}; cast with .to(torch.int32) "
                "after checking ids fit")
        mx = int(nb.max())
        if mx >= n:
            row = int(torch.argmax((nb.max(dim=1).values >= n).to(torch.int8)))
            raise ValueError(
                f"neighbor id {mx} out of range for N={n} nodes (first bad "
                f"row: local {row} = global {self.offset + row})"
                f"{self._where()} — ids must be shard-local; a value in "
                f"[{n}, ∞) usually means a global id leaked into a shard "
                "slice")
        mn = int(nb.min())
        if mn < -1:
            raise ValueError(
                f"neighbor id {mn} < -1 (only -1 marks an empty slot)"
                f"{self._where()}")
        rows = torch.arange(n, device=nb.device, dtype=nb.dtype)[:, None]
        loops = ((nb == rows) & (nb >= 0)).any(dim=1)
        if bool(loops.any()):
            bad = int(torch.argmax(loops.to(torch.int8)))
            raise ValueError(
                f"self loop at node {bad} ({int(loops.sum())} total)"
                f"{self._where()} — prune self edges before building an "
                "engine")
        if not 0 <= self.entry_point < n:
            raise ValueError(f"entry_point {self.entry_point} outside "
                             f"[0, {n}){self._where()}")


@dataclasses.dataclass
class ShardedGraphIndex:
    """S independent per-slice graphs over one corpus.

    Slices are contiguous and equal-sized: shard s owns global rows
    [s·n_s, (s+1)·n_s). Every shard graph is self-contained (local ids,
    its own medoid entry point), so each shard runs the unmodified
    lockstep loop; the cross-shard top-k merge (`distributed/merge.py`) is
    the only global operation.
    """

    shards: list  # [S] GraphIndex, equal n and degree

    def __post_init__(self):
        if not self.shards:
            raise ValueError("ShardedGraphIndex needs at least one shard")
        ns = {g.n for g in self.shards}
        if len(ns) != 1:
            raise ValueError(
                f"shard sizes must match (equal contiguous slices), got "
                f"{sorted(ns)}")
        rs = {g.degree for g in self.shards}
        if len(rs) != 1:
            raise ValueError(f"shard degrees must match, got {sorted(rs)}")

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_size(self) -> int:
        return self.shards[0].n

    @property
    def n(self) -> int:
        return self.shard_size * self.n_shards

    @property
    def degree(self) -> int:
        return self.shards[0].degree

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def offsets(self) -> np.ndarray:
        """[S] global row id of each shard's local row 0."""
        return np.asarray([g.offset for g in self.shards], np.int32)

    @property
    def entry_points(self) -> np.ndarray:
        """[S] shard-local entry node ids."""
        return np.asarray([g.entry_point for g in self.shards], np.int32)

    def validate(self) -> None:
        for s, g in enumerate(self.shards):
            if g.shard != s:
                raise ValueError(
                    f"shard list order broken: position {s} holds shard "
                    f"{g.shard}")
            if g.offset != s * self.shard_size:
                raise ValueError(
                    f"shard {s} offset {g.offset} != contiguous slice start "
                    f"{s * self.shard_size}")
            g.validate()
