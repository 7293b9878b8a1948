"""NVIDIA H100 SXM constants: the card the port runs on.

The reference's ``hw.py`` holds the TPU v5e's.  These are the published
rates of NVIDIA's H100 SXM data sheet (dense, without sparsity), which
assume the card's full power limit of 700 W; a card set below it runs
slower under load, so a share of these peaks is stated with the card's
``nvidia-smi`` power limit beside it.
"""

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: dense tensor-core peaks, operations/s
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_TF32 = 494.7e12
#: float32 outside the tensor cores; taken as the rate of a kernel's scalar
#: integer and float64 work too, an upper bound on it, so a bound computed
#: from it is a lower bound on the time
PEAK_FLOPS_F32 = 67e12
