"""build_model(cfg) — the single entry point from config to model."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import DecoderLM

# family → the ROADMAP.md item that ports it
UNPORTED = {
    "ssm": "Queue 1, item 5d (Mamba2: SSM and hybrid)",
    "hybrid": "Queue 1, item 5d (Mamba2: SSM and hybrid)",
    "vlm": "Queue 1, item 5e (VLM cross-attention)",
    "encdec": "Queue 1, item 5f (enc-dec)",
}


def build_model(cfg: ArchConfig, device=None,
                generator: torch.Generator | None = None) -> DecoderLM:
    """The decoder LM of `cfg` (dense or MoE, gqa or MLA attention, with
    an MTP head where `cfg.mtp` is set) on `device` (the card by default),
    its weights drawn from `generator` (default: seed 0 on that device).
    Raises NotImplementedError for a family not ported yet, naming its
    ROADMAP.md item; nothing falls back."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} is not ported to repro_torch yet "
            f"(ROADMAP.md {UNPORTED.get(cfg.family, 'Queue 1, item 5')})")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return DecoderLM(cfg, device=dev, generator=generator)
