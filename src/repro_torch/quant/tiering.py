"""Memory tiering for the full-precision vector store.

Counterpart of `repro/quant/tiering.py`. With a quantized traversal (int8,
PQ) the card needs only the compressed codes: the float32 vectors are
read once a query, by the terminal rerank, and only for the ≤ M + K pool
rows that survived. That access (small, batched, by index) lets the
float32 store leave the card:

  card   compressed codes, norms and errors, graph, packed attributes
  host   float32 vectors — `HostVectorStore`, streamed per rerank batch

`HostVectorStore` keeps its only copy in pinned host memory (the
reference's `pinned_host` memory kind): `gather` indexes the pool's rows
on the host into a pinned [B, P, d] slab and copies it to the card with
`non_blocking=True`, so the copy is a DMA from page-locked memory and the
card never holds the [N, d] array. If the store is meant for a CUDA
device and pinning fails, it raises; a store for a CPU engine keeps
ordinary host memory (there is no card to tier from). The rows are the
same bytes either way, so the rerank's results are bit for bit the
device tier's.

`DeviceVectorStore` is the tier for small corpora — the same gather,
vectors on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _as_f32_rows(vectors) -> torch.Tensor:
    if isinstance(vectors, torch.Tensor):
        return vectors.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(vectors, np.float32))


class DeviceVectorStore:
    """Device-resident float32 vector tier."""

    kind = "device"

    def __init__(self, vectors, device=None):
        self.vectors = _as_f32_rows(vectors).to(
            resolve_device(device)).contiguous()

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @property
    def shape(self):
        return tuple(self.vectors.shape)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * 4

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows `idx` [B, P] → [B, P, d] (negative ids read row 0; callers
        mask them, as `exact_rerank` does)."""
        return self.vectors[idx.clamp(min=0).long()]


class HostVectorStore:
    """Pinned host-memory float32 vector tier with a batched gather."""

    kind = "host"

    def __init__(self, vectors, device=None):
        self.device = resolve_device(device)
        host = _as_f32_rows(vectors).cpu().contiguous()
        self.pinned = self.device.type == "cuda"
        if self.pinned:
            host = host.pin_memory()   # raises if the host cannot pin it
            if not host.is_pinned():
                raise RuntimeError("HostVectorStore: pin_memory() returned "
                                   "pageable memory")
        self._host = host

    @property
    def shape(self):
        return tuple(self._host.shape)

    @property
    def nbytes(self) -> int:
        return self._host.numel() * 4

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows `idx` [B, P] → [B, P, d] on the store's device; negative
        ids read row 0. The rows are indexed on the host into one pinned
        slab, then copied without blocking the host, so the transfer is
        B·P·d floats a batch, whatever N."""
        flat = idx.reshape(-1).clamp(min=0).to("cpu", torch.long)
        d = self._host.shape[1]
        out = torch.empty((flat.numel(), d), dtype=torch.float32,
                          pin_memory=self.pinned)
        torch.index_select(self._host, 0, flat, out=out)
        out = out.reshape(*idx.shape, d)
        return out.to(self.device, non_blocking=self.pinned)


def as_vector_store(vectors, tier: str = "device", device=None):
    """The tier named by `tier` ("device" | "host") over `vectors`, for
    an engine on `device`."""
    if tier == "device":
        return DeviceVectorStore(vectors, device)
    if tier == "host":
        return HostVectorStore(vectors, device)
    raise ValueError(f"unknown vector tier {tier!r} "
                     "(expected 'device' or 'host')")
