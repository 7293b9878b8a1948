"""Segment sum, radix rank/partition and hash-table build/probe: the join
and group-by cores of the engine.  ``ops`` picks the CUDA kernel
(``kernel``) or the plain version (``ref``) by the tensor's device."""
