def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (hand-written kernels of the "
        "PyTorch port); skips where torch.cuda.is_available() is False")
