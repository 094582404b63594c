"""Filter predicates for attributed vector datasets (paper §2.1) — host side.

Copy of `repro/filters/predicates.py` (PRED_* tags, `FilterSpec`,
`pack_labels`, the naive `filter_matrix` oracle and `selectivity`), for
`FilterSpec` batches and sequences of filter-algebra expressions
(`filters.expr`). Label sets are packed multi-hot uint32 words here, as in
`repro`; the device side holds the same bits as int32 (see
`filters.compile`).

`filter_matrix` is the host *oracle*: deliberately naive numpy broadcast,
nothing like the compiled program path the traversal runs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Predicate type tags.
PRED_CONTAIN = 0  # L_q ⊆ A_i
PRED_EQUAL = 1    # L_q = A_i
PRED_RANGE = 2    # A_i ∈ [lo, hi]


def pack_labels(label_sets: Sequence[Sequence[int]], alphabet_size: int) -> np.ndarray:
    """Pack per-item label sets into [N, W] uint32 multi-hot bitmasks."""
    n_words = max(1, (alphabet_size + 31) // 32)
    out = np.zeros((len(label_sets), n_words), dtype=np.uint32)
    for i, labels in enumerate(label_sets):
        for lab in labels:
            if not 0 <= lab < alphabet_size:
                raise ValueError(f"label {lab} outside alphabet [0,{alphabet_size})")
            out[i, lab // 32] |= np.uint32(1) << np.uint32(lab % 32)
    return out


def pack_query_labels(labels: Sequence[int], alphabet_size: int) -> np.ndarray:
    """Pack one query label set into a [W] uint32 mask."""
    return pack_labels([labels], alphabet_size)[0]


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """A batched single-kind filter workload.

    Exactly one of (label_masks) or (range_lo, range_hi) is set, matching
    `kind`. Arrays carry a leading query-batch dimension [B, ...].
    """

    kind: int  # PRED_CONTAIN | PRED_EQUAL | PRED_RANGE
    label_masks: np.ndarray | None = None  # [B, W] uint32
    range_lo: np.ndarray | None = None     # [B] float32
    range_hi: np.ndarray | None = None     # [B] float32

    @property
    def batch(self) -> int:
        if self.kind == PRED_RANGE:
            return int(self.range_lo.shape[0])
        return int(self.label_masks.shape[0])

    def slice(self, sl) -> "FilterSpec":
        if self.kind == PRED_RANGE:
            return FilterSpec(self.kind, None, self.range_lo[sl], self.range_hi[sl])
        return FilterSpec(self.kind, self.label_masks[sl], None, None)

    def to_expr(self) -> list:
        """The batch as per-query single-leaf filter-algebra expressions,
        which compile to the same single-clause program."""
        from repro_torch.filters.expr import (Contain, Equal, Range,
                                              labels_from_mask)

        if self.kind == PRED_RANGE:
            return [Range(float(lo), float(hi))
                    for lo, hi in zip(self.range_lo, self.range_hi)]
        leaf = Contain if self.kind == PRED_CONTAIN else Equal
        return [leaf(labels_from_mask(m)) for m in self.label_masks]


def slice_filter(filt, s: int, e: int):
    """Queries [s:e) of a FilterSpec batch or a sequence of expressions."""
    if isinstance(filt, FilterSpec):
        return filt.slice(slice(s, e))
    return list(filt)[s:e]


def filter_matrix(filt, labels_packed: np.ndarray | None,
                  values: np.ndarray | None) -> np.ndarray:
    """[B, N] bool validity of every item under every query's filter.

    `filt` is a FilterSpec batch or a sequence of filter-algebra
    expressions (evaluated by the recursive `eval_expr`, per query).
    Materializes [B, N(, W)] intermediates — callers with large B chunk
    over queries (see `selectivity`).
    """
    if not isinstance(filt, FilterSpec):
        from repro_torch.filters.expr import eval_expr

        return np.stack([eval_expr(e, labels_packed, values) for e in filt])
    if filt.kind == PRED_RANGE:
        v = np.asarray(values)
        v = (v[:, 0] if v.ndim == 2 else v)[None, :]  # channel 0 [1, N]
        return (v >= filt.range_lo[:, None]) & (v <= filt.range_hi[:, None])
    masks = filt.label_masks[:, None, :]  # [B,1,W]
    items = labels_packed[None, :, :]     # [1,N,W]
    if filt.kind == PRED_CONTAIN:
        return ((items & masks) == masks).all(axis=-1)
    return (items == masks).all(axis=-1)


def selectivity(filt, labels_packed: np.ndarray | None,
                values: np.ndarray | None, chunk: int = 64) -> np.ndarray:
    """Global selectivity σ_global per query (paper Def. 2.6), on host.

    Chunked over queries so the naive broadcast peaks at chunk·N·W.
    """
    filt = filt if isinstance(filt, FilterSpec) else list(filt)
    b = filt.batch if isinstance(filt, FilterSpec) else len(filt)
    out = np.empty(b, np.float64)
    for s in range(0, b, max(1, chunk)):
        e = min(s + chunk, b)
        out[s:e] = filter_matrix(slice_filter(filt, s, e), labels_packed,
                                 values).mean(axis=1)
    return out
