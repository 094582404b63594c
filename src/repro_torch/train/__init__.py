"""Training and serving steps of the LM zoo (counterpart of
`repro/train`): AdamW with float32 / bfloat16 / int8 moments, the train
step with gradient accumulation and int8 error feedback, checkpoints in
the reference's format, and prefill / decode / generate."""
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         dequantize, init_opt_state, quantize)
from repro_torch.train.serve_step import (generate, greedy, make_decode_step,
                                          make_prefill)
from repro_torch.train.train_step import (TrainConfig, load_state_,
                                          loss_and_grads, make_init_state,
                                          make_train_step)

__all__ = [
    "AdamWConfig", "init_opt_state", "adamw_update", "quantize",
    "dequantize",
    "TrainConfig", "make_train_step", "make_init_state", "loss_and_grads",
    "load_state_", "CheckpointManager",
    "greedy", "make_prefill", "make_decode_step", "generate",
]
