"""build_model(cfg) — the single entry point from config to model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM

# family → the ROADMAP.md item that ports it
UNPORTED = {
    "vlm": "Queue 1, item 5e (VLM cross-attention)",
    "encdec": "Queue 1, item 5f (enc-dec)",
}


def build_model(cfg: ArchConfig, device=None,
                generator: torch.Generator | None = None) -> DecoderLM:
    """The decoder LM of `cfg` (dense or MoE, gqa or MLA attention, with
    an MTP head where `cfg.mtp` is set; Mamba2 layers, with zamba2's
    shared attention block in the hybrid) on `device` (the card by
    default), its weights drawn from `generator` (default: seed 0 on that
    device).
    Raises NotImplementedError for a family not ported yet, naming its
    ROADMAP.md item; nothing falls back."""
    if cfg.family in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} is not ported to repro_torch yet "
            f"(ROADMAP.md {UNPORTED[cfg.family]})")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return DecoderLM(cfg, device=dev, generator=generator)
