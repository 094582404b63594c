"""The LM zoo (counterpart of `repro/models`): the dense, MoE, SSM
(Mamba2) and hybrid (zamba2) decoder families, gqa or MLA attention,
with deepseek-v3's MTP head — training loss, prefill and cached
decode."""
from repro_torch.models.transformer import (BlockType, Ctx, DecoderLM,
                                            Segment)
from repro_torch.models.zoo import build_model

__all__ = ["DecoderLM", "BlockType", "Segment", "Ctx", "build_model"]
