"""PyTorch/CUDA port of the filtered-AKNN engine (`repro`'s counterpart).

Module names mirror `repro` (`repro_torch/core/state.py` ↔
`repro/core/state.py`, ...). The port imports neither `jax` nor `repro`;
what it needs of `repro`'s numpy modules it keeps as its own copy.

Entry points run on the CUDA device unless the caller passes
`device="cpu"` (see `repro_torch.device.resolve_device`). The traversal
step and the GBDT estimator run through hand-written CUDA kernels
(`repro_torch/csrc/`) on CUDA tensors, and through their plain PyTorch
versions on CPU tensors.
"""
