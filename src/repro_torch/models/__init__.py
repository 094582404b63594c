"""The LM zoo's serving path (counterpart of `repro/models`): the dense
decoder family, prefill and KV-cache decode."""
from repro_torch.models.transformer import (BlockType, Ctx, DecoderLM,
                                            Segment)
from repro_torch.models.zoo import build_model

__all__ = ["DecoderLM", "BlockType", "Segment", "Ctx", "build_model"]
