"""The LM zoo (counterpart of `repro/models`): the dense and MoE decoder
families — training loss, prefill and KV-cache decode."""
from repro_torch.models.transformer import (BlockType, Ctx, DecoderLM,
                                            Segment)
from repro_torch.models.zoo import build_model

__all__ = ["DecoderLM", "BlockType", "Segment", "Ctx", "build_model"]
