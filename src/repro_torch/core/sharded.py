"""Index-axis sharding: per-shard traversal + log-depth global top-k merge.

Counterpart of `repro/core/sharded.py`, its loop path (the mesh path —
a ("data", "index") device mesh joined by a butterfly merge — needs
several GPUs and comes later; `mesh` accepts only None until then).

`SearchEngine` holds the whole index. This module cuts the corpus into S
contiguous equal slices, each with its own graph (shard-local node ids,
its own entry point), quant codes and attributes. A query traverses every
shard under ⌈W/S⌉ of its budget, with per-shard state (candidate queue,
result set, visited bitset over the shard's N/S nodes), and the S sorted
pools are combined by the cross-shard merge (`distributed.merge`) into
the global result set. The shards run one
after another on one device, each through the plain per-shard
`SearchEngine.search` (persistent driver, compaction and tracing
included), then `merge_shard_states` merges the stacked states.

Pool entries carry unique (dist, pos) keys (pos = shard · width + slot), a
total order under which top-m is associative and commutative, so any
merge gives the one sorted top-m of the pool union. The merge moves
distances and never recomputes them; the counters are summed in shard
order by elementwise adds, so no value depends on the batch width.

Accounting contract (what keeps the estimator, the planner, probe →
resume and EXPLAIN working unchanged):

  exact      cnt (NDC), n_inspected, n_valid_visited, n_clause_valid,
             n_pop_valid, hops — integer sums over shards; q_err_sum — a
             float sum in shard order.
  semantics  active = any(shard active); d_start = min over shards (the
             best entry distance a query saw); visited = the per-shard
             bitsets laid end to end, [B, S·ceil(Ns/32)].
  approx     conv_cnt / res_full_cnt: summed when every shard reached the
             milestone, else -1 ("not yet"), which the feature extractor
             reads as "not converged".

Memory tiering composes as on the plain engine: compressed shard engines
hold [Ns, 0] float32 placeholders, and the exact rerank reads one global
`quant.tiering` store (device or pinned host memory), gathering only the
≤ M + K merged-pool rows a query.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import SearchEngine, _labels_to_torch
from repro_torch.core.state import (SearchConfig, SearchState, stack_shards,
                                    take_shard)
from repro_torch.data.synthetic import AttributedDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.merge import merge_plan, merge_stacked
from repro_torch.filters.compile import (MATRIX_CHUNK, FilterProgram,
                                         as_program, program_to)
from repro_torch.index.graph import ShardedGraphIndex
from repro_torch.kernels.topk import pack_payload, unpack_payload
from repro_torch.obs.trace import as_tracer


class ShardedSearchState(NamedTuple):
    """Full state of a sharded search: per-shard carries + the merged view.

    `shard` is a SearchState whose leaves carry the shard axis second
    ([B, S, ...]), so the serving layer's lane surgery (take / put / concat
    / pad on axis 0) works on sharded states unchanged. `merged` is a
    plain [B, ...] SearchState — the global view every consumer (features,
    planner, EXPLAIN, rerank, serving) reads; all 18 SearchState field
    names delegate to it. Resume reads `shard`; results read `merged`.
    """

    shard: SearchState    # [B, S, ...] leaves
    merged: SearchState   # [B, ...] leaves — global pools + summed counters

    # -- delegation: every SearchState field name reads the merged view ----
    @property
    def cand_dist(self): return self.merged.cand_dist

    @property
    def cand_idx(self): return self.merged.cand_idx

    @property
    def cand_exp(self): return self.merged.cand_exp

    @property
    def cand_valid(self): return self.merged.cand_valid

    @property
    def res_dist(self): return self.merged.res_dist

    @property
    def res_idx(self): return self.merged.res_idx

    @property
    def visited(self): return self.merged.visited

    @property
    def cnt(self): return self.merged.cnt

    @property
    def n_inspected(self): return self.merged.n_inspected

    @property
    def n_valid_visited(self): return self.merged.n_valid_visited

    @property
    def n_clause_valid(self): return self.merged.n_clause_valid

    @property
    def n_pop_valid(self): return self.merged.n_pop_valid

    @property
    def q_err_sum(self): return self.merged.q_err_sum

    @property
    def hops(self): return self.merged.hops

    @property
    def active(self): return self.merged.active

    @property
    def d_start(self): return self.merged.d_start

    @property
    def conv_cnt(self): return self.merged.conv_cnt

    @property
    def res_full_cnt(self): return self.merged.res_full_cnt


def _shard_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the shard axis 1 in shard order, by elementwise adds (a
    lane's value does not depend on the batch width; integers keep
    their dtype)."""
    out = x[:, 0]
    for i in range(1, x.shape[1]):
        out = out + x[:, i]
    return out


def _merged_from(stacked: SearchState, rd, rp, cd, cp) -> SearchState:
    """Assemble the merged view from stacked states + already-merged pools.
    The merged bitset is a copy: lane surgery writes `shard` and `merged`
    one after the other and must not write one through the other."""
    b = stacked.res_dist.shape[0]
    ci, ce, cv = unpack_payload(cp)

    def opt(x):
        # "reached on every shard": the sum when all shards report ≥ 0,
        # else the -1 "not yet" the feature extractor substitutes for
        return torch.where((x >= 0).all(dim=1), _shard_sum(x),
                           -1).to(torch.int32)

    return SearchState(
        cand_dist=cd.contiguous(), cand_idx=ci, cand_exp=ce, cand_valid=cv,
        res_dist=rd.contiguous(), res_idx=rp.contiguous(),
        visited=stacked.visited.reshape(b, -1).clone(),
        cnt=_shard_sum(stacked.cnt),
        n_inspected=_shard_sum(stacked.n_inspected),
        n_valid_visited=_shard_sum(stacked.n_valid_visited),
        n_clause_valid=_shard_sum(stacked.n_clause_valid),
        n_pop_valid=_shard_sum(stacked.n_pop_valid),
        q_err_sum=_shard_sum(stacked.q_err_sum),
        hops=_shard_sum(stacked.hops),
        active=stacked.active.any(dim=1),
        d_start=stacked.d_start.min(dim=1).values,
        conv_cnt=opt(stacked.conv_cnt),
        res_full_cnt=opt(stacked.res_full_cnt),
    )


def _merge_pools(stacked: SearchState, offsets):
    """The cross-shard merge of the stacked per-shard pools → global
    pools.

    Result pools merge on bare global ids; candidate pools pack (global
    id, expanded, valid) into one int32 payload (`kernels.topk`), so the
    queue flags ride the merge with their entry."""
    k = stacked.res_dist.shape[2]
    m = stacked.cand_dist.shape[2]
    off = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                          device=stacked.res_idx.device)[None, :, None]
    res_g = torch.where(stacked.res_idx >= 0, stacked.res_idx + off, -1)
    rd, rp, _ = merge_stacked(stacked.res_dist, res_g.to(torch.int32), k)
    cand_g = torch.where(stacked.cand_idx >= 0, stacked.cand_idx + off, -1)
    cpay = pack_payload(cand_g.to(torch.int32), stacked.cand_exp,
                        stacked.cand_valid)
    cd, cp, _ = merge_stacked(stacked.cand_dist, cpay, m)
    return rd, rp, cd, cp


def merge_shard_states(stacked: SearchState, offsets) -> SearchState:
    """Merged global view of stacked per-shard states ([B, S, ...] leaves).

    `offsets` [S] — each shard's first global row (shard-local id i of
    shard s ↦ global id offsets[s] + i)."""
    rd, rp, cd, cp = _merge_pools(stacked, offsets)
    return _merged_from(stacked, rd, rp, cd, cp)


@dataclasses.dataclass
class ShardedSearchEngine:
    """S per-shard `SearchEngine`s + the cross-shard merge, one facade.

    Duck-type compatible with `SearchEngine` wherever the stack consumes an
    engine (`search` / `rerank` / `compile` / `codec_key` / `n_words` /
    `device` / ...); its states are `ShardedSearchState`s, whose fields
    read the merged global view.
    """

    shards: list                       # [S] SearchEngine
    offsets: np.ndarray                # [S] first global row per shard
    entry_points: np.ndarray           # [S] shard-local entry node ids
    backend: str | None = None
    mesh: object | None = None         # None: the loop path (only one)
    precision: str = "float32"
    vector_store: object | None = None  # global rerank tier (compressed)

    #: duck-typing marker — plans and the planner route on this
    is_sharded: ClassVar[bool] = True

    # ------------------------------------------------------------ build ----
    @classmethod
    def build(cls, ds: AttributedDataset, graph: ShardedGraphIndex,
              backend: str | None = None, mesh=None,
              precision: str = "float32", quant_cfg: dict | None = None,
              tier: str = "device", device=None) -> "ShardedSearchEngine":
        """An index-axis-sharded engine over `ds` on `device` (the card by
        default).

        graph   a ShardedGraphIndex (`index.build_sharded_graph_index`).
        mesh    None (the loop path over shards on one device); a mesh
                raises until the mesh path lands.
        tier    "device" | "host" — where the float32 rerank tier lives
                in compressed mode (`quant.tiering`). Compressed shard
                engines hold [Ns, 0] vector placeholders: one global
                float32 copy exists, in the chosen tier.

        A float32 build reads `ds.vectors` as one float32 tensor on the
        device (no copy when it already is one) and gives each shard a
        view of its slice. Quantized builds train every shard's codec on
        the same global sample (`ds.sample_vectors`), so the codec
        parameters — the compressed metric and the per-query ADC prep —
        are the same on every shard and the merged pool lives in one
        metric.
        """
        if mesh is not None:
            raise ValueError(
                "the mesh path of the sharded engine needs several GPUs and "
                "is not ported yet; pass mesh=None (the loop over shards)")
        dev = resolve_device(device)
        graph.validate()
        n, s = graph.n, graph.n_shards
        if len(ds.vectors) != n:
            raise ValueError(
                f"dataset has {len(ds.vectors)} rows but the sharded graph "
                f"covers {n}")
        if tier != "device" and precision == "float32":
            raise ValueError(
                "tier='host' requires a compressed traversal precision "
                "('int8' or 'pq') — a float32 traversal reads the full "
                "vector store every step, which defeats the tier")
        ns = graph.shard_size
        offsets = np.asarray(graph.offsets)

        quants = [None] * s
        store = vectors = None
        if precision != "float32":
            from repro_torch.quant.codecs import build_quant_index
            from repro_torch.quant.tiering import as_vector_store

            qcfg = dict(quant_cfg or {})
            sample_n = qcfg.pop("train_sample_size", 16384)
            sample = ds.sample_vectors(sample_n, seed=qcfg.get("seed", 0))
            quants = [
                build_quant_index(precision,
                                  ds.vectors[offsets[i]:offsets[i] + ns],
                                  train_sample=sample, device=dev, **qcfg)
                for i in range(s)
            ]
            store = as_vector_store(ds.vectors, tier, dev)
        else:
            vectors = torch.as_tensor(ds.vectors).to(dev, torch.float32)

        labels = np.asarray(ds.labels_packed)
        vals = np.asarray(ds.value_matrix, np.float32)
        shards = []
        for i in range(s):
            lo, hi = int(offsets[i]), int(offsets[i]) + ns
            vec = (torch.zeros((ns, 0), dtype=torch.float32, device=dev)
                   if vectors is None else vectors[lo:hi])
            shards.append(SearchEngine(
                base_vectors=vec,
                label_attrs=_labels_to_torch(labels[lo:hi], dev),
                value_attrs=torch.from_numpy(
                    np.ascontiguousarray(vals[lo:hi])).to(dev),
                neighbors=graph.shards[i].neighbors.to(
                    dev, torch.int32).contiguous(),
                entry_point=int(graph.shards[i].entry_point),
                backend=backend,
                precision=precision,
                quant=quants[i],
            ))
        return cls(shards=shards, offsets=offsets,
                   entry_points=np.asarray(graph.entry_points),
                   backend=backend, mesh=None, precision=precision,
                   vector_store=store)

    # ------------------------------------------------------- properties ----
    @property
    def tier(self) -> str:
        """Where the float32 rerank rows live: the vector store's kind, or
        "device" for a float32 engine, whose shards hold them."""
        store = self.vector_store
        return "device" if store is None else store.kind

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_size(self) -> int:
        return int(self.shards[0].neighbors.shape[0])

    @property
    def n(self) -> int:
        return self.n_shards * self.shard_size

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def n_words(self) -> int:
        return self.shards[0].n_words

    @property
    def n_values(self) -> int:
        return self.shards[0].n_values

    @property
    def quant(self):
        """Shard 0's quant index — the codec parameters are shared by the
        training contract, so this is *the* codec for identity purposes."""
        return self.shards[0].quant

    @property
    def quant_concat(self):
        """Global-view quant index: the shards' codes / norms / errors
        concatenated in shard order (= global row order), codec parameters
        from shard 0. What corpus-wide consumers (the compressed ground
        truth in `core.training` / `core.planner`) read; not cached."""
        q0 = self.shards[0].quant
        if q0 is None:
            return None
        from repro_torch.quant.codecs import Int8Index, PQIndex

        def cat(name):
            return torch.cat([getattr(e.quant, name) for e in self.shards])

        if isinstance(q0, Int8Index):
            return Int8Index(codes=cat("codes"), scale=q0.scale,
                             zero=q0.zero, norms=cat("norms"),
                             err=cat("err"))
        if isinstance(q0, PQIndex):
            return PQIndex(codes=cat("codes"), codebooks=q0.codebooks,
                           norms=cat("norms"), err=cat("err"))
        raise TypeError(f"unknown quant index {type(q0).__name__}")

    @property
    def label_attrs(self) -> torch.Tensor:
        """Concatenated [N, W] label words (global row order), for host
        consumers; traversals read the per-shard tensors, never this."""
        return torch.cat([e.label_attrs for e in self.shards])

    @property
    def value_attrs(self) -> torch.Tensor:
        return torch.cat([e.value_attrs for e in self.shards])

    def compile(self, filt) -> FilterProgram:
        return program_to(as_program(filt, self.n_words, self.n_values),
                          self.device)

    def effective_precision(self, cfg: SearchConfig) -> str:
        return cfg.precision or self.precision

    def codec_key(self, cfg: SearchConfig | None = None) -> str:
        return self.shards[0].codec_key(cfg)

    # ----------------------------------------------------------- search ----
    def _resolve(self, cfg: SearchConfig) -> SearchConfig:
        if cfg.backend is None:
            cfg = dataclasses.replace(cfg, backend=self.backend or "dense")
        cfg = dataclasses.replace(cfg,
                                  precision=self.effective_precision(cfg))
        if cfg.precision != "float32" and self.quant is None:
            raise ValueError(
                f"SearchConfig(precision={cfg.precision!r}) on a sharded "
                "engine without a quant index — build with precision=...")
        if (cfg.precision == "float32"
                and self.shards[0].base_vectors.shape[1] == 0):
            raise ValueError(
                "float32 traversal on a compressed sharded engine: shards "
                "hold only vector placeholders (the float32 copy lives in "
                "the rerank tier) — search at the engine's compressed "
                "precision, the terminal rerank stays exact")
        return cfg

    def search(self, cfg: SearchConfig, queries, filt, budgets,
               state: ShardedSearchState | None = None,
               gt_dist=None, tracer=None, trace_id: str = "",
               ) -> ShardedSearchState:
        """Sharded search / probe / resume. Same contract as
        `SearchEngine.search`, except that states are ShardedSearchStates
        and `budgets` is the *global* NDC budget: each shard runs under
        ⌈W/S⌉, and the merged `cnt` is the exact total the query spent
        (Σ per-shard NDC), which the features and EXPLAIN read. The spans
        ("shard-search" per shard, "shard-merge") wrap host dispatches
        that happen with tracing off too, with host-int attributes."""
        cfg = self._resolve(cfg)
        dev = self.device
        prog = self.compile(filt)
        q = torch.as_tensor(queries).to(dev, torch.float32).contiguous()
        b = q.shape[0]
        s = self.n_shards
        w = torch.as_tensor(np.asarray(budgets) if not isinstance(
            budgets, torch.Tensor) else budgets).to(dev, torch.int64)
        w = w.expand(b) if w.ndim == 0 else w
        # each shard's slice of the global budget: ⌈W/S⌉, so S·slice ≥ W
        # and a budget-terminated query still shows cnt ≥ W to EXPLAIN
        sbud = ((w + (s - 1)) // s).to(torch.int32).contiguous()
        tr = as_tracer(tracer)
        outs = []
        for i, eng in enumerate(self.shards):
            st = None if state is None else take_shard(state.shard, i)
            with tr.span("shard-search", trace_id, shard=i, n_shards=s):
                outs.append(eng.search(
                    cfg, q, prog, sbud, state=st, gt_dist=gt_dist,
                    tracer=tracer,
                    trace_id=f"{trace_id}/s{i}" if trace_id else ""))
        pairwise, depth = merge_plan(s)
        with tr.span("shard-merge", trace_id, n_shards=s, pairwise=pairwise,
                     depth=depth, path="loop"):
            stacked = stack_shards(outs)
            merged = merge_shard_states(stacked, self.offsets)
        return ShardedSearchState(shard=stacked, merged=merged)

    # ------------------------------------------------------------- scan ----
    def scan_stats(self, prog: FilterProgram, chunk: int = MATRIX_CHUNK):
        """Global ScanStats from per-shard bitmap passes: counts are the
        sums of the shards' popcounts, clause_frac the Ns-weighted mean of
        the shards' fractions (the reference's float32 arithmetic)."""
        from repro_torch.core.plans import ScanStats, scan_stats

        per = [scan_stats(e, prog, chunk=chunk) for e in self.shards]
        valid = torch.cat([p.valid for p in per], dim=1)
        frac = np.sum([p.clause_frac * p.n for p in per], axis=0)
        frac = (frac / max(self.n, 1)).astype(np.float32)
        return ScanStats(valid=valid,
                         counts=valid.sum(dim=1).cpu().numpy().astype(
                             np.int64),
                         clause_frac=frac, n=self.n)

    def scan(self, cfg: SearchConfig, queries, filt, stats=None,
             base_state: ShardedSearchState | None = None,
             ) -> ShardedSearchState:
        """The pre-filter scan plan on a sharded engine: per-shard scans
        over the bitmap's slices, merged like a traversal. The merged cnt
        adds exactly σ_q·N and the result pool equals the unsharded scan's
        (same distances, same global-id tie order). Per-shard clause_add
        rounds rint(frac·Ns), so the merged n_clause_valid may differ from
        the unsharded rint(frac·N) by ±S/2 — a feature input, not an
        accounting value."""
        from repro_torch.core.plans import ScanStats, scan_search

        prog = self.compile(filt)
        if stats is None:
            stats = self.scan_stats(prog)
        ns = self.shard_size
        outs = []
        for i, eng in enumerate(self.shards):
            lo = int(self.offsets[i])
            sl = stats.valid[:, lo:lo + ns]
            sstats = ScanStats(valid=sl,
                               counts=sl.sum(dim=1).cpu().numpy().astype(
                                   np.int64),
                               clause_frac=stats.clause_frac, n=ns)
            bs = (None if base_state is None
                  else take_shard(base_state.shard, i))
            outs.append(scan_search(eng, cfg, queries, prog, stats=sstats,
                                    base_state=bs))
        stacked = stack_shards(outs)
        merged = merge_shard_states(stacked, self.offsets)
        return ShardedSearchState(shard=stacked, merged=merged)

    # ----------------------------------------------------------- rerank ----
    def rerank_arrays(self, queries, state):
        """Exact float32 re-scoring of the merged candidate pool through
        the global vector store — ≤ M + K gathered rows a query."""
        from repro_torch.quant.rerank import exact_rerank_store

        st = state.merged if isinstance(state, ShardedSearchState) else state
        if self.vector_store is None:
            raise ValueError("rerank on a float32 sharded engine is a no-op "
                             "(results are already exact)")
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        return exact_rerank_store(q, self.vector_store, st.cand_idx,
                                  st.cand_valid, st.res_idx,
                                  int(st.res_idx.shape[1]))

    def rerank(self, cfg: SearchConfig, queries,
               state: ShardedSearchState) -> ShardedSearchState:
        """Terminal exact rerank of the merged view (a no-op at float32).
        Only `merged` is rewritten — per-shard carries keep compressed
        pools; like the plain engine's, a reranked state is not resumed."""
        if self.effective_precision(cfg) == "float32":
            return state
        rd, ri = self.rerank_arrays(queries, state)
        return ShardedSearchState(
            shard=state.shard,
            merged=state.merged._replace(res_dist=rd, res_idx=ri))
