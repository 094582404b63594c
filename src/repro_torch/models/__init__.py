"""The LM zoo (counterpart of `repro/models`): the dense, MoE, SSM
(Mamba2) and hybrid (zamba2) decoder families, gqa or MLA attention,
with deepseek-v3's MTP head, the VLM's cross-attention decoder and the
enc-dec (whisper) — training loss, prefill and cached decode."""
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import (BlockType, Ctx, DecoderLM,
                                            Segment)
from repro_torch.models.zoo import build_model

__all__ = ["DecoderLM", "EncDecLM", "BlockType", "Segment", "Ctx",
           "build_model"]
