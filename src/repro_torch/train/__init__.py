"""Training substrate: optimizers over nested dicts of tensors, the train
step (loss, gradient accumulation, recomputation), checkpoints in the
reference's on-disk layout, int8 gradient compression and the resilient
loop.  The counterpart of ``src/repro/train``."""
