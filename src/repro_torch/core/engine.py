"""SearchEngine — the device-resident index + traversal facade.

Counterpart of `repro/core/engine.py::SearchEngine`. It bundles the
tensors every search needs (vectors, packed attributes, graph, entry
point and, at precision "int8" or "pq", the quant index), compiles
filters to programs and runs `run_search`, or `run_search_persistent`
for a persistent backend. A quantized engine keeps the float vectors for
the terminal exact rerank (`rerank`): on the device, or with
`tier="host"` in pinned host memory (`quant.tiering.HostVectorStore`),
leaving only an [N, 0] placeholder on the device.

With a batch mesh (`make_search_mesh`, a 1-D ("data",)
`distributed.sharding.Mesh`) the index is replicated — placed once a
distinct device — and the batch is cut into one contiguous slice a
position, padded to a multiple of the positions with inert lanes (0
budget, match-nothing program rows). Each position runs `run_search` on
its slice, persistent backends included, as the reference's `shard_map`
body does; the lockstep loop has no cross-lane dependence, so every lane
equals the unmeshed run's bit for bit. The mesh is single-controller and
may repeat a device (a stated departure, `distributed/sharding.py`):
`[cuda:0] × 4` runs four positions one after another on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.backends import get_backend
from repro_torch.core.search import run_search, run_search_persistent
from repro_torch.core.state import (SearchConfig, SearchState, concat_lanes,
                                    pad_lanes, slice_lanes, tree_to)
from repro_torch.data.synthetic import AttributedDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (BATCH_AXIS, Mesh,
                                              canonical_device,
                                              visible_devices)
from repro_torch.filters.compile import FilterProgram, as_program, program_to
from repro_torch.index.graph import GraphIndex
from repro_torch.quant.codecs import build_quant_index, codec_key
from repro_torch.quant.rerank import exact_rerank, exact_rerank_store
from repro_torch.quant.tiering import as_vector_store

BIG_BUDGET = 1 << 30


def make_search_mesh(devices=None) -> Mesh | None:
    """1-D ("data",) batch mesh over `devices` (the visible cards, each
    once, by default; an explicit list may repeat a device); None on a
    single device."""
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) <= 1:
        return None
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr, (BATCH_AXIS,))


def resolve_mesh(mesh, device, auto) -> tuple:
    """A build's `mesh` and `device` → (the mesh or None, the engine's
    device). "auto" calls `auto()` (None on one card) when the device is
    a card, else gives None; on a mesh the engine lives on its first
    entry, which a `device` given beside it must name."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', a Mesh or None, "
                             f"not {mesh!r}")
        mesh = auto() if resolve_device(device).type == "cuda" else None
    if mesh is None:
        return None, resolve_device(device)
    if device is not None and canonical_device(device) != mesh.first:
        raise ValueError(f"device {device} is not the mesh's first entry "
                         f"{mesh.first}: an engine on a mesh lives there")
    return mesh, mesh.first


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
    mesh: Mesh | None = None     # 1-D batch mesh (first axis = batch);
                                 # None → one device
    _replicas: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)  # device → index tensors

    @property
    def device(self) -> torch.device:
        return self.base_vectors.device

    @classmethod
    def build(cls, ds: AttributedDataset, graph: GraphIndex,
              backend: str | None = None, device=None,
              precision: str = "float32", quant_cfg: dict | None = None,
              tier: str = "device", mesh: Mesh | str | None = "auto",
              ) -> "SearchEngine":
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
        mesh       "auto": a 1-D batch mesh over the visible cards when the
                   engine's device is a card and more than one is visible
                   (`make_search_mesh`), else None; an explicit `Mesh`
                   (its first axis the batch axis; it may repeat a
                   device); None: one device. On a mesh the engine lives
                   on the mesh's first entry and the index is placed once
                   on each distinct device.
        """
        mesh, dev = resolve_mesh(mesh, device, make_search_mesh)
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
            mesh=mesh,
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
        if mesh is not None:
            for d in mesh.distinct:
                eng._index_on(d)
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
        loop, and a mesh's `run_search` per position, take none, as in
        the reference."""
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
        if self.mesh is not None:
            return self._search_sharded(cfg, q, prog, budgets, state, gt,
                                        quant)
        args = (cfg, q, prog, self.base_vectors,
                (self.label_attrs, self.value_attrs), self.neighbors,
                budgets, self.entry_point)
        if getattr(get_backend(cfg.backend), "persistent", False):
            return run_search_persistent(*args, state=state, gt_dist=gt,
                                         quant=quant, tracer=tracer,
                                         trace_id=trace_id)
        return run_search(*args, state=state, gt_dist=gt, quant=quant)

    # ------------------------------------------------------ batch mesh ----
    def _index_on(self, device) -> tuple:
        """(vectors, (labels, values), neighbors, quant) on `device`: the
        engine's own tensors on its device, else one copy a distinct
        device, made on first use and kept."""
        if self._replicas is None:
            self._replicas = {}
        dev = canonical_device(device)
        if dev not in self._replicas:
            self._replicas[dev] = tree_to(
                (self.base_vectors, (self.label_attrs, self.value_attrs),
                 self.neighbors, self.quant), dev)
        return self._replicas[dev]

    def _search_sharded(self, cfg, q, prog, budgets, state, gt, quant):
        """The batch mesh: pad the batch to a multiple of the batch axis
        with inert lanes, run `run_search` on each position's contiguous
        slice on its device (persistent backends included: the launch
        loop's compaction is not crossed by the mesh, as in the
        reference, so `dispatch_counters` do not move), and concatenate
        the slices on the first device without the pad."""
        devices = list(self.mesh.grid(self.mesh.axis_names[0]))
        n = len(devices)
        b = q.shape[0]
        pad = (-b) % n
        # pad lanes: 0 NDC budget (they stop at once), all-zero
        # (match-nothing) program rows, zero queries
        q, prog, budgets, state, gt = pad_lanes(
            (q, prog, budgets, state, gt), pad)
        per = (b + pad) // n
        outs = []
        for i, dev in enumerate(devices):
            sq, sprog, sbud, sst, sgt = tree_to(slice_lanes(
                (q, prog, budgets, state, gt), i * per, (i + 1) * per), dev)
            base, attrs, nb, qt = self._index_on(dev)
            outs.append(run_search(
                cfg, sq, sprog, base, attrs, nb, sbud, self.entry_point,
                state=sst, gt_dist=sgt, quant=None if quant is None else qt))
        out = concat_lanes([tree_to(o, devices[0]) for o in outs])
        return slice_lanes(out, 0, b) if pad else out
