"""Hand-written CUDA kernels (K1 fused step, K2 GBDT) with their plain
PyTorch versions, and the helpers around them."""
