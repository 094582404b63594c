"""SearchEngine — the device-resident index + traversal facade.

Counterpart of `repro/core/engine.py::SearchEngine` for one device (the
batch mesh waits for the mesh path, which needs several GPUs). It bundles
the tensors every search needs (vectors, packed attributes, graph, entry
point and, at precision "int8" or "pq", the quant index), compiles
filters to programs and runs `run_search`, or `run_search_persistent`
for a persistent backend. A quantized engine keeps the float vectors for
the terminal exact rerank (`rerank`): on the device, or with
`tier="host"` in pinned host memory (`quant.tiering.HostVectorStore`),
leaving only an [N, 0] placeholder on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.search import run_search, run_search_persistent
from repro_torch.core.state import SearchConfig, SearchState
from repro_torch.data.synthetic import AttributedDataset
from repro_torch.device import resolve_device
from repro_torch.filters.compile import FilterProgram, as_program, program_to
from repro_torch.index.graph import GraphIndex
from repro_torch.quant.codecs import build_quant_index, codec_key
from repro_torch.quant.rerank import exact_rerank, exact_rerank_store
from repro_torch.quant.tiering import as_vector_store

BIG_BUDGET = 1 << 30


def _labels_to_torch(labels, device) -> torch.Tensor:
    """[N, W] uint32 label words → int32 tensor with the same bits."""
    if isinstance(labels, torch.Tensor):
        return labels.to(device=device, dtype=torch.int32).contiguous()
    a = np.ascontiguousarray(labels)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


@dataclasses.dataclass
class SearchEngine:
    base_vectors: torch.Tensor   # [N, d] f32
    label_attrs: torch.Tensor    # [N, W] i32 (uint32 bit patterns)
    value_attrs: torch.Tensor    # [N, V] f32
    neighbors: torch.Tensor      # [N, R] i32
    entry_point: int
    backend: str | None = None   # None → whatever SearchConfig carries
    precision: str = "float32"   # deployment default; a per-call
                                 # SearchConfig(precision=...) wins
    quant: object | None = None  # Int8Index | PQIndex for int8 / pq
    vector_store: object | None = None  # quant.tiering store of the exact
                                 # rerank; when set (host tier),
                                 # base_vectors is an [N, 0] placeholder
                                 # whose row count alone is read

    @property
    def device(self) -> torch.device:
        return self.base_vectors.device

    @classmethod
    def build(cls, ds: AttributedDataset, graph: GraphIndex,
              backend: str | None = None, device=None,
              precision: str = "float32", quant_cfg: dict | None = None,
              tier: str = "device") -> "SearchEngine":
        """Place the dataset and graph on `device` (the card by default).

        precision  "float32", or "int8" / "pq": train the codec on a sample
                   of the dataset, encode every vector on the device, and
                   traverse in the compressed domain.
        quant_cfg  codec knobs for `quant.build_quant_index` (pq_subspaces,
                   pq_centroids, pq_iters, pq_levels, seed), plus
                   "train_sample_size" (default 16384) for the sample.
        tier       "device" keeps the float32 vectors on the device; "host"
                   (a compressed precision only) keeps them in pinned host
                   memory for the rerank and only an [N, 0] placeholder
                   on the device.
        """
        dev = resolve_device(device)
        graph.validate()
        values = np.asarray(ds.value_matrix, np.float32)
        store = None
        if tier != "device":
            if precision == "float32":
                raise ValueError(
                    "tier='host' requires a compressed traversal precision "
                    "('int8' or 'pq') — a float32 traversal reads the full "
                    "vector store every step, which defeats the tier")
            store = as_vector_store(ds.vectors, tier, dev)
            vectors = torch.zeros((len(ds.vectors), 0), dtype=torch.float32,
                                  device=dev)
        else:
            vectors = torch.as_tensor(ds.vectors).to(dev, torch.float32)
        eng = cls(
            base_vectors=vectors,
            label_attrs=_labels_to_torch(ds.labels_packed, dev),
            value_attrs=torch.from_numpy(values).to(dev),
            neighbors=graph.neighbors.to(dev, torch.int32).contiguous(),
            entry_point=int(graph.entry_point),
            backend=backend,
            precision=precision,
            vector_store=store,
        )
        if precision != "float32":
            qcfg = dict(quant_cfg or {})
            sample_n = qcfg.pop("train_sample_size", 16384)
            sample = ds.sample_vectors(sample_n, seed=qcfg.get("seed", 0))
            # encoded from the dataset's rows, chunk by chunk: a host-tier
            # engine never holds them on the device
            eng.quant = build_quant_index(
                precision, eng.base_vectors if store is None else ds.vectors,
                train_sample=sample, device=dev, **qcfg)
        return eng

    @property
    def n_words(self) -> int:
        return int(self.label_attrs.shape[1])

    @property
    def n_values(self) -> int:
        return int(self.value_attrs.shape[1])

    def compile(self, filt) -> FilterProgram:
        """Lower a FilterSpec, an Expr or a list of Exprs (or carry a
        FilterProgram) onto the device."""
        return program_to(as_program(filt, self.n_words, self.n_values),
                          self.device)

    def effective_precision(self, cfg: SearchConfig) -> str:
        """The precision a call with `cfg` runs at (per-call override wins)."""
        return cfg.precision or self.precision

    def codec_key(self, cfg: SearchConfig | None = None) -> str:
        """Codec identity ("float32" | "int8:…" | "pq:…") of the precision
        a call with `cfg` runs at (the engine's without `cfg`)."""
        prec = self.precision if cfg is None else self.effective_precision(cfg)
        return codec_key(prec, self.quant)

    def rerank_arrays(self, queries, state: SearchState):
        """Exact float32 re-scoring of a finished traversal's pool (result
        set ∪ valid candidate queue) → (res_dist [B, K], res_idx [B, K])."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if self.vector_store is not None:
            return exact_rerank_store(q, self.vector_store, state.cand_idx,
                                      state.cand_valid, state.res_idx,
                                      int(state.res_idx.shape[1]))
        return exact_rerank(q, self.base_vectors, state.cand_idx,
                            state.cand_valid, state.res_idx,
                            int(state.res_idx.shape[1]))

    def rerank(self, cfg: SearchConfig, queries, state: SearchState,
               ) -> SearchState:
        """Terminal exact rerank: the result buffers become the float32
        top-k of the pool. A no-op at float32. The returned state must not
        be resumed (exact results, compressed queue)."""
        if self.effective_precision(cfg) == "float32":
            return state
        rd, ri = self.rerank_arrays(queries, state)
        return state._replace(res_dist=rd, res_idx=ri)

    def search(
        self,
        cfg: SearchConfig,
        queries,                      # [B, d] numpy or torch
        filt,                         # FilterSpec | Expr(s) | FilterProgram
        budgets,                      # scalar or [B]
        state: SearchState | None = None,
        gt_dist=None,                 # [B, K] for convergence tracking
        tracer=None,                  # obs.Tracer | None — persistent loop
        trace_id: str = "",           # spans only; never reaches a kernel
    ) -> SearchState:
        """Run (or resume) the lockstep search. `tracer` / `trace_id` reach
        the persistent launch loop (one span per launch); the single-step
        loop takes none, as in the reference."""
        cfg = dataclasses.replace(cfg, degree=int(self.neighbors.shape[1]))
        if cfg.backend is None:
            cfg = dataclasses.replace(cfg, backend=self.backend or "dense")
        cfg = dataclasses.replace(cfg, precision=self.effective_precision(cfg))
        if cfg.precision != "float32" and self.quant is None:
            raise ValueError(
                f"SearchConfig(precision={cfg.precision!r}) on an engine "
                "without a quant index — build with precision=...")
        if cfg.precision == "float32" and self.base_vectors.shape[1] == 0:
            raise ValueError(
                "float32 traversal on a host-tiered engine: the device "
                "holds only a vector placeholder — search at the engine's "
                "compressed precision (rerank stays exact via the host "
                "tier) or rebuild with tier='device'")
        quant = self.quant if cfg.precision != "float32" else None
        dev = self.device
        prog = self.compile(filt)
        q = torch.as_tensor(queries).to(dev, torch.float32).contiguous()
        b = q.shape[0]
        budgets = torch.as_tensor(np.asarray(budgets) if not isinstance(
            budgets, torch.Tensor) else budgets).to(dev, torch.int32)
        budgets = budgets.expand(b).contiguous() if budgets.ndim == 0 \
            else budgets.contiguous()
        gt = None if gt_dist is None else torch.as_tensor(gt_dist).to(
            dev, torch.float32)
        args = (cfg, q, prog, self.base_vectors,
                (self.label_attrs, self.value_attrs), self.neighbors,
                budgets, self.entry_point)
        if getattr(get_backend(cfg.backend), "persistent", False):
            return run_search_persistent(*args, state=state, gt_dist=gt,
                                         quant=quant, tracer=tracer,
                                         trace_id=trace_id)
        return run_search(*args, state=state, gt_dist=gt, quant=quant)
