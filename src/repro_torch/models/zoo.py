"""build_model(cfg) — the single entry point from config to model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import DecoderLM


def model_class(cfg: ArchConfig) -> type[DecoderLM]:
    """`EncDecLM` for the enc-dec family, `DecoderLM` for every other."""
    return EncDecLM if cfg.family == "encdec" else DecoderLM


# family → the memory its cross-attention reads (stubbed in both packages)
MEMORY = {"vlm": "image patch embeddings", "encdec": "audio frames"}


def refuse_memory(cfg: ArchConfig, what: str) -> None:
    """Raise ValueError where `what`, a path that feeds tokens alone,
    would run a model of `cfg` that cross-attends to a memory."""
    if cfg.family in MEMORY:
        raise ValueError(
            f"{cfg.name} cross-attends to a memory of {MEMORY[cfg.family]} "
            f"(batch['enc'] / enc=); {what} feeds tokens alone")


def build_model(cfg: ArchConfig, device=None,
                generator: torch.Generator | None = None) -> DecoderLM:
    """The LM of `cfg` (`model_class`: dense or MoE, gqa or MLA attention,
    with an MTP head where `cfg.mtp` is set; Mamba2 layers, with zamba2's
    shared attention block in the hybrid; the VLM's cross blocks; the
    enc-dec's encoder and cross-attending decoder) on `device` (the card
    by default), its weights drawn from `generator` (default: seed 0 on
    that device)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return model_class(cfg)(cfg, device=dev, generator=generator)
