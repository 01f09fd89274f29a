"""Hand-written Hopper kernels (``csrc/``), each beside its plain PyTorch
version; ``ops`` holds the public wrappers."""
