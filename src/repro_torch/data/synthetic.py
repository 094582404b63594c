"""Synthetic attributed-vector datasets with controllable query↔filter
correlation — host-side numpy, copied from `repro/data/synthetic.py`.

The generators draw with numpy `default_rng` exactly as `repro` does, so
the same seed gives bit-identical arrays in both packages (the parity
tests pin it), and `make_composite_workload` the same expressions. See
`repro/data/synthetic.py` for the construction.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.filters.predicates import (
    FilterSpec,
    PRED_CONTAIN,
    PRED_EQUAL,
    PRED_RANGE,
    pack_labels,
)


@dataclasses.dataclass
class AttributedDataset:
    """Host-side attributed vector dataset (paper Def. 2.1).

    Items carry one label-set attribute (packed multi-hot) plus one or more
    numeric attribute channels: `values` is the primary channel (kept 1-D
    for the legacy FilterSpec range path) and `values_aux` holds any extra
    channels the filter algebra's `Range(..., attr=c)` can address.
    """

    name: str
    vectors: np.ndarray          # [N, d] float32, unit norm
    labels_packed: np.ndarray    # [N, W] uint32 multi-hot
    label_sets: list             # python list of per-item label tuples
    values: np.ndarray           # [N] float32 numeric attribute (channel 0)
    alphabet_size: int
    cluster_ids: np.ndarray      # [N] int32 (generation metadata)
    values_aux: np.ndarray | None = None  # [N, V-1] float32 extra channels

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def n_words(self) -> int:
        return self.labels_packed.shape[1]

    @property
    def n_value_attrs(self) -> int:
        return 1 + (0 if self.values_aux is None else self.values_aux.shape[1])

    @property
    def value_matrix(self) -> np.ndarray:
        """[N, V] float32 — every numeric channel, channel 0 = `values`."""
        if self.values_aux is None:
            return self.values[:, None]
        return np.concatenate([self.values[:, None], self.values_aux], axis=1)

    def sample_vectors(self, n: int, seed: int = 0) -> np.ndarray:
        """Deterministic without-replacement vector sample.

        Codec fitting (k-means codebooks, int8 min/max) doesn't need the
        full corpus; a bounded sample keeps quantized-engine bring-up
        independent of N. Returns the full set when n >= N.
        """
        if n >= self.n:
            return self.vectors
        idx = np.random.default_rng(seed).choice(self.n, size=n, replace=False)
        return self.vectors[idx]


@dataclasses.dataclass
class QueryWorkload:
    """A batch of filtered queries q = (x_q, f_q) plus generation metadata.

    Filters are carried either as a single-kind `FilterSpec` batch
    (`spec`) or as per-query filter-algebra expressions (`exprs`, from
    `make_composite_workload`). `filters` is the form to hand to
    `engine.search` and the exact oracle.
    """

    queries: np.ndarray       # [B, d] float32
    spec: FilterSpec | None   # batched single-kind filters (legacy form)
    sigma_global: np.ndarray  # [B] measured global selectivity
    hardness: np.ndarray      # [B] 0 = aligned/easy, 1 = anti-correlated/hard
    exprs: list | None = None  # [B] filter-algebra expressions

    @property
    def batch(self) -> int:
        return self.queries.shape[0]

    @property
    def filters(self):
        return self.exprs if self.exprs is not None else self.spec

    def filter_slice(self, s: int, e: int):
        """Filters of queries [s:e), in whichever form the workload holds."""
        if self.exprs is not None:
            return self.exprs[s:e]
        return self.spec.slice(slice(s, e))


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def make_dataset(
    n: int = 20000,
    dim: int = 64,
    n_clusters: int = 32,
    alphabet_size: int = 64,
    max_labels: int = 3,
    label_skew: float = 4.0,
    value_noise: float = 0.1,
    seed: int = 0,
    name: str = "synthetic",
    n_value_attrs: int = 2,
) -> AttributedDataset:
    rng = np.random.default_rng(seed)
    centers = _unit(rng.normal(size=(n_clusters, dim)).astype(np.float32))
    cluster_ids = rng.integers(0, n_clusters, size=n).astype(np.int32)
    spread = 0.35
    vecs = centers[cluster_ids] + spread * rng.normal(size=(n, dim)).astype(np.float32)
    vecs = _unit(vecs).astype(np.float32)

    # Per-cluster label distribution: a Zipf-ish reweighting of a random
    # permutation of the alphabet, so each cluster concentrates on a few
    # "home" labels but shares tails with others.
    label_probs = np.zeros((n_clusters, alphabet_size), dtype=np.float64)
    base = 1.0 / np.arange(1, alphabet_size + 1) ** label_skew
    for c in range(n_clusters):
        perm = rng.permutation(alphabet_size)
        label_probs[c, perm] = base
    label_probs /= label_probs.sum(axis=1, keepdims=True)

    label_sets = []
    for i in range(n):
        k = int(rng.integers(1, max_labels + 1))
        labs = rng.choice(alphabet_size, size=k, replace=False, p=label_probs[cluster_ids[i]])
        label_sets.append(tuple(sorted(int(x) for x in labs)))
    labels_packed = pack_labels(label_sets, alphabet_size)

    # Numeric attribute: noisy linear probe of the vector, rescaled to [0,1].
    w = rng.normal(size=dim).astype(np.float32)
    raw = vecs @ w + value_noise * rng.normal(size=n).astype(np.float32)
    values = (raw - raw.min()) / max(raw.max() - raw.min(), 1e-9)
    values = values.astype(np.float32)

    # Extra numeric channels (for the filter algebra's Range(..., attr=c)):
    # independent noisy probes, drawn *after* every legacy stream draw so
    # channel 0 / labels / vectors are bit-identical to n_value_attrs=1.
    values_aux = None
    if n_value_attrs > 1:
        cols = []
        for _ in range(n_value_attrs - 1):
            wa = rng.normal(size=dim).astype(np.float32)
            ra = vecs @ wa + value_noise * rng.normal(size=n).astype(np.float32)
            cols.append((ra - ra.min()) / max(ra.max() - ra.min(), 1e-9))
        values_aux = np.stack(cols, axis=1).astype(np.float32)

    return AttributedDataset(
        name=name,
        vectors=vecs,
        labels_packed=labels_packed,
        label_sets=label_sets,
        values=values,
        alphabet_size=alphabet_size,
        cluster_ids=cluster_ids,
        values_aux=values_aux,
    )


def _sample_query_vectors(ds: AttributedDataset, b: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Perturbed held-in samples: on-manifold queries (paper §5.1)."""
    idx = rng.integers(0, ds.n, size=b)
    q = ds.vectors[idx] + 0.05 * rng.normal(size=(b, ds.dim)).astype(np.float32)
    return _unit(q).astype(np.float32), idx


def make_label_workload(
    ds: AttributedDataset,
    batch: int = 64,
    kind: Literal["contain", "equal"] = "contain",
    hard_fraction: float = 0.5,
    seed: int = 1,
) -> QueryWorkload:
    """Label-filtered queries.

    Easy/aligned: filter = subset of the labels of a data item *near* the
    query (high ρ_local). Hard/anti-correlated: filter = labels of an item
    from a *different* cluster (σ_global similar, ρ_local ≈ 0) — the paper's
    feature-filter misalignment.
    """
    rng = np.random.default_rng(seed)
    q, src_idx = _sample_query_vectors(ds, batch, rng)
    hard = (rng.random(batch) < hard_fraction).astype(np.int32)
    masks = np.zeros((batch, ds.n_words), dtype=np.uint32)
    ptag = PRED_CONTAIN if kind == "contain" else PRED_EQUAL
    for i in range(batch):
        if hard[i]:
            # borrow the label set of an item in another cluster
            while True:
                j = int(rng.integers(0, ds.n))
                if ds.cluster_ids[j] != ds.cluster_ids[src_idx[i]]:
                    break
        else:
            j = int(src_idx[i])
        labs = ds.label_sets[j]
        if ptag == PRED_CONTAIN and len(labs) > 1:
            # containment uses a random non-empty subset
            ksub = int(rng.integers(1, len(labs) + 1))
            labs = tuple(rng.choice(labs, size=ksub, replace=False))
        for lab in labs:
            masks[i, lab // 32] |= np.uint32(1) << np.uint32(lab % 32)
    spec = FilterSpec(kind=ptag, label_masks=masks)

    from repro_torch.filters.predicates import selectivity

    sig = selectivity(spec, ds.labels_packed, ds.values)
    return QueryWorkload(queries=q, spec=spec, sigma_global=sig, hardness=hard.astype(np.float32))


def make_range_workload(
    ds: AttributedDataset,
    batch: int = 64,
    selectivities: tuple = (0.01, 0.05, 0.10, 0.20),
    hard_fraction: float = 0.5,
    seed: int = 2,
) -> QueryWorkload:
    """Range-filtered queries with controlled σ_global.

    The range width is chosen on the empirical value CDF so that the window
    covers exactly `sel` of the dataset. Easy: window centered at the
    query's own attribute value. Hard: window centered at the *opposite*
    quantile (anti-correlated with the query's neighborhood).
    """
    rng = np.random.default_rng(seed)
    q, src_idx = _sample_query_vectors(ds, batch, rng)
    hard = (rng.random(batch) < hard_fraction).astype(np.int32)
    sorted_vals = np.sort(ds.values)
    n = ds.n
    lo = np.zeros(batch, dtype=np.float32)
    hi = np.zeros(batch, dtype=np.float32)
    for i in range(batch):
        sel = float(rng.choice(selectivities))
        width = max(2, int(round(sel * n)))
        own_val = ds.values[src_idx[i]]
        own_rank = int(np.searchsorted(sorted_vals, own_val))
        if hard[i]:
            center = n - 1 - own_rank  # opposite quantile
        else:
            center = own_rank
        start = int(np.clip(center - width // 2, 0, n - width))
        lo[i] = sorted_vals[start]
        hi[i] = sorted_vals[start + width - 1]
    spec = FilterSpec(kind=PRED_RANGE, range_lo=lo, range_hi=hi)

    from repro_torch.filters.predicates import selectivity

    sig = selectivity(spec, ds.labels_packed, ds.values)
    return QueryWorkload(queries=q, spec=spec, sigma_global=sig, hardness=hard.astype(np.float32))


def _window_on_cdf(sorted_vals: np.ndarray, center_rank: int, sel: float,
                   ) -> tuple[float, float]:
    """[lo, hi] covering `sel` of the empirical CDF around a rank."""
    n = sorted_vals.shape[0]
    width = max(2, int(round(sel * n)))
    start = int(np.clip(center_rank - width // 2, 0, n - width))
    return float(sorted_vals[start]), float(sorted_vals[start + width - 1])


def make_composite_workload(
    ds: AttributedDataset,
    batch: int = 64,
    structure: Literal["and", "or", "not", "mixed"] = "and",
    hard_fraction: float = 0.5,
    selectivities: tuple = (0.05, 0.10, 0.20),
    seed: int = 3,
) -> QueryWorkload:
    """Composite-filter workloads over the filter algebra (PathFinder-style).

    Per-leaf selectivity is controlled the same way as the single-kind
    generators (label leaves borrow real item label sets; range leaves take
    windows on the empirical value CDF), and the easy/hard axis is the
    paper's correlation knob: easy leaves describe the query's own
    neighborhood, hard leaves an anti-correlated one.

      and    Contain(labels near query) ∧ Range(value window)   — the
             canonical "tag AND price band" conjunction; σ_global is the
             product-ish of the leaf selectivities, ρ_local diverges per
             leaf (exactly what the per-clause rho features observe).
      or     Contain(tags A) ∨ Contain(tags B from another cluster) — the
             multi-tag disjunction; hard queries draw *both* tag sets from
             foreign clusters.
      not    Range(wide window) ∧ ¬In(blacklisted labels) — exclusion
             filtering (negated any-of).
      mixed  uniform mix of the above plus bare single-leaf filters —
             the serving-layer stress shape (heterogeneous structure in
             one batch).
    """
    from repro_torch.filters.expr import And, Contain, In, Not, Or, Range

    rng = np.random.default_rng(seed)
    q, src_idx = _sample_query_vectors(ds, batch, rng)
    hard = (rng.random(batch) < hard_fraction).astype(np.int32)
    n_chan = ds.n_value_attrs
    vm = ds.value_matrix
    sorted_by_chan = [np.sort(vm[:, c]) for c in range(n_chan)]
    rank_by_chan = [np.searchsorted(sorted_by_chan[c], vm[:, c])
                    for c in range(n_chan)]

    def other_cluster_item(i):
        while True:
            j = int(rng.integers(0, ds.n))
            if ds.cluster_ids[j] != ds.cluster_ids[src_idx[i]]:
                return j

    def label_subset(j):
        labs = ds.label_sets[j]
        ksub = int(rng.integers(1, len(labs) + 1))
        return tuple(int(x) for x in rng.choice(labs, size=ksub, replace=False))

    def contain_leaf(i):
        j = other_cluster_item(i) if hard[i] else int(src_idx[i])
        return Contain(label_subset(j))

    def range_leaf(i, sel=None, chan=None):
        c = int(rng.integers(0, n_chan)) if chan is None else chan
        sel = float(rng.choice(selectivities)) if sel is None else sel
        own_rank = int(rank_by_chan[c][src_idx[i]])
        center = (ds.n - 1 - own_rank) if hard[i] else own_rank
        lo, hi = _window_on_cdf(sorted_by_chan[c], center, sel)
        return Range(lo, hi, attr=c)

    def build(i, shape):
        if shape == "and":
            return And(contain_leaf(i), range_leaf(i))
        if shape == "or":
            a = Contain(label_subset(other_cluster_item(i) if hard[i]
                                     else int(src_idx[i])))
            b = Contain(label_subset(other_cluster_item(i)))
            return Or(a, b)
        if shape == "not":
            # generous range minus a foreign cluster's tag blacklist
            wide = range_leaf(i, sel=0.5)
            block = In(label_subset(other_cluster_item(i)))
            return And(wide, Not(block))
        if shape == "contain":
            return contain_leaf(i)
        if shape == "range":
            return range_leaf(i)
        raise ValueError(shape)

    shapes = (["and", "or", "not", "contain", "range"] if structure == "mixed"
              else [structure])
    exprs = [build(i, shapes[int(rng.integers(0, len(shapes)))])
             for i in range(batch)]

    from repro_torch.filters.predicates import selectivity

    sig = selectivity(exprs, ds.labels_packed, vm)
    return QueryWorkload(queries=q, spec=None, sigma_global=sig,
                         hardness=hard.astype(np.float32), exprs=exprs)


# Named presets standing in for the paper's four datasets, scaled to the
# container (scaling factors recorded in EXPERIMENTS.md).
DATASET_PRESETS = {
    # paper: Tripclick 1.0M x 768, clinical-area labels  -> scaled
    "tripclick-s": dict(n=20000, dim=96, n_clusters=24, alphabet_size=48, max_labels=3, seed=11),
    # paper: Youtube 1.0M x 128, audio tags
    "youtube-s": dict(n=20000, dim=64, n_clusters=40, alphabet_size=64, max_labels=4, seed=12),
    # paper: Arxiv 1.7M x 4096, categories + dates
    "arxiv-s": dict(n=24000, dim=128, n_clusters=32, alphabet_size=40, max_labels=2, seed=13),
    # paper: MSMARCO 1.0M x 1024, synthetic int attr
    "msmarco-s": dict(n=20000, dim=96, n_clusters=16, alphabet_size=32, max_labels=2, seed=14),
}


def make_preset(name: str, **overrides) -> AttributedDataset:
    cfg = dict(DATASET_PRESETS[name])
    cfg.update(overrides)
    return make_dataset(name=name, **cfg)
