"""Flash attention: two online-softmax kernels written for Hopper (bf16 on
the tensor cores, ``csrc/flash_attention_sm90.cu``; float32 on the CUDA
cores, ``csrc/flash_attention.cu``), their plain PyTorch version, and the
reference's model-layout contract.  ``ops`` picks a CUDA kernel
(``kernel``, by dtype) or the plain version (``ref``) by the tensor's
device."""
