"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside a
plain PyTorch version of the same contract."""
