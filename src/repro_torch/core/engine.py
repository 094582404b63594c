"""SearchEngine — the device-resident index + traversal facade.

Counterpart of `repro/core/engine.py::SearchEngine` for one device (the
batch mesh and the quantized domain wait for later slices). It bundles
the tensors every search needs (vectors, packed attributes, graph, entry
point), compiles filters to programs and runs `run_search`, or
`run_search_persistent` for a persistent backend.
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
    precision: str = "float32"

    @property
    def device(self) -> torch.device:
        return self.base_vectors.device

    @classmethod
    def build(cls, ds: AttributedDataset, graph: GraphIndex,
              backend: str | None = None, device=None) -> "SearchEngine":
        """Place the dataset and graph on `device` (the card by default)."""
        dev = resolve_device(device)
        graph.validate()
        values = np.asarray(ds.value_matrix, np.float32)
        return cls(
            base_vectors=torch.as_tensor(ds.vectors).to(dev, torch.float32),
            label_attrs=_labels_to_torch(ds.labels_packed, dev),
            value_attrs=torch.from_numpy(values).to(dev),
            neighbors=graph.neighbors.to(dev, torch.int32).contiguous(),
            entry_point=int(graph.entry_point),
            backend=backend,
        )

    @property
    def n_words(self) -> int:
        return int(self.label_attrs.shape[1])

    @property
    def n_values(self) -> int:
        return int(self.value_attrs.shape[1])

    def compile(self, filt) -> FilterProgram:
        """Lower a FilterSpec (or carry a FilterProgram) onto the device."""
        return program_to(as_program(filt, self.n_words, self.n_values),
                          self.device)

    def effective_precision(self, cfg: SearchConfig) -> str:
        """The precision a call with `cfg` runs at (per-call override wins)."""
        return cfg.precision or self.precision

    def rerank(self, cfg: SearchConfig, queries, state: SearchState,
               ) -> SearchState:
        """Terminal exact rerank — a no-op at float32, the only precision
        of this slice."""
        del cfg, queries
        return state

    def search(
        self,
        cfg: SearchConfig,
        queries,                      # [B, d] numpy or torch
        filt,                         # FilterSpec | FilterProgram
        budgets,                      # scalar or [B]
        state: SearchState | None = None,
        gt_dist=None,                 # [B, K] for convergence tracking
    ) -> SearchState:
        cfg = dataclasses.replace(cfg, degree=int(self.neighbors.shape[1]))
        if cfg.backend is None:
            cfg = dataclasses.replace(cfg, backend=self.backend or "dense")
        cfg = dataclasses.replace(cfg, precision=self.effective_precision(cfg))
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
        search = (run_search_persistent
                  if getattr(get_backend(cfg.backend), "persistent", False)
                  else run_search)
        return search(cfg, q, prog, self.base_vectors,
                      (self.label_attrs, self.value_attrs), self.neighbors,
                      budgets, self.entry_point, state=state, gt_dist=gt)
