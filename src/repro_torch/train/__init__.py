"""Serving steps of the LM zoo (counterpart of `repro/train`). Training —
`train_step`, the optimizer and checkpoints — is not ported yet
(ROADMAP.md Queue 1, item 5a)."""
from repro_torch.train.serve_step import (generate, greedy, make_decode_step,
                                          make_prefill)

__all__ = ["greedy", "make_prefill", "make_decode_step", "generate"]
