"""MoE dispatch and combine: direct-addressed kernels written for Hopper
(``csrc/moe_dispatch.cu``), their plain PyTorch versions, and the
reference's contracts.  ``ops`` picks the CUDA kernels (``kernel``) or the
plain versions (``ref``) by the tensor's device."""
