"""Flash attention: an online-softmax kernel written for Hopper
(``csrc/flash_attention.cu``), its plain PyTorch version, and the
reference's model-layout contract.  ``ops`` picks the CUDA kernel
(``kernel``) or the plain version (``ref``) by the tensor's device."""
