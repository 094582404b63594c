"""Encoder-decoder LM (whisper-small's backbone).

Counterpart of `repro/models/encdec.py`. The audio frontend (mel and the
convolutional downsampling) is a stub, as in the reference: the memory
`enc` [B, encoder_seq, d] carries precomputed frame embeddings. The
encoder is a stack of `n_encoder_layers` bidirectional gqa blocks
(roped at positions 0..Se − 1), then `enc_norm`; the decoder is a
`DecoderLM` whose every block cross-attends to the encoder's output. A
decode step reads the decoder's self-attention K/V and the static cross
K/V that prefill cached, never the encoder.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.transformer import (BlockType, Ctx, DecoderLM,
                                            _init_block)


class EncDecLM(DecoderLM):
    """The decoder (`layer_plan`: (gqa + cross) × n_layers) drawn as
    `DecoderLM` draws it, then the encoder's `enc_layers` and `enc_norm`,
    as the reference's `init_params` draws them after the decoder."""

    enc_type = BlockType("gqa", bidir=True)

    def __init__(self, cfg: ArchConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(cfg, device=device, generator=generator)
        dev = self.device
        self.enc_layers = nn.ModuleList(
            _init_block(cfg, self.enc_type, generator, dev)
            for _ in range(cfg.n_encoder_layers))
        self.enc_norm = init_norm(cfg, cfg.d_model, dev)

    def encode(self, frames):
        """frames [B, Se, d] (the stub frontend's output) → the encoder's
        states [B, Se, d]. Under `cfg.remat`, where autograd records (the
        loss), each encoder layer is checkpointed and recomputed on
        backward, as the reference's scan body is."""
        b, se, _ = frames.shape
        positions = torch.arange(se, device=frames.device)[None].expand(b, se)
        ctx = Ctx(mode="train", positions=positions)
        x = frames.to(self.cfg.compute_dtype)
        for blk in self.enc_layers:
            if self.cfg.remat and torch.is_grad_enabled():
                x = checkpoint(self._enc_layer, blk, x, ctx,
                               use_reentrant=False)
            else:
                x = self._enc_layer(blk, x, ctx)
        return apply_norm(self.cfg, self.enc_norm, x)

    def _enc_layer(self, blk, x, ctx: Ctx):
        return self._applier(self.enc_type, blk, x, ctx)[0]

    def _frames(self, frames, what: str):
        if frames is None:
            raise ValueError(
                f"{self.cfg.name}: {what} needs the encoder's input frames "
                f"[B, {self.cfg.encoder_seq}, {self.cfg.d_model}] "
                "(batch['enc'] / enc=), got none")
        return frames

    def loss(self, batch):
        """`DecoderLM.loss` with the memory `encode(batch["enc"])`."""
        frames = self._frames(batch.get("enc"), "loss")
        return super().loss({**batch, "enc": self.encode(frames)})

    @torch.no_grad()
    def prefill(self, tokens, drops: list | None = None, enc=None):
        """`DecoderLM.prefill` with the memory `encode(enc)`, enc the
        frames [B, Se, d]."""
        enc = self.encode(self._frames(enc, "prefill"))
        return super().prefill(tokens, drops=drops, enc=enc)
