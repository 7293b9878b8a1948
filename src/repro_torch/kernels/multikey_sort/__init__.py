"""Multi-key sort: a stable LSD radix pass written for Hopper
(``csrc/multikey_sort.cu``), its plain PyTorch version, and the
reference's public sort ops."""
