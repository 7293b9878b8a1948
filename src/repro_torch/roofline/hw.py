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

#: device memory of one H100 SXM: 80 GB of HBM3 (NVIDIA's data sheet
#: says "80GB"; the card reports 81,559 MiB, of which PyTorch can allocate
#: a little less), taken as 80 · 10^9 bytes, a bound every plan must fit
HBM_BYTES = 80 * 10**9

#: NVLink 4 of one H100 SXM: 900 GB/s of bidirectional bandwidth a card
#: (data sheet: 18 links at 50 GB/s), so 450e9 bytes/s in each direction;
#: it takes the place of the reference's per-link ICI rate, and, as that
#: one, a collective's bytes divided by it are the time one direction of
#: the card's links takes to carry them
NVLINK_BW = 450e9
