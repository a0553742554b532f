"""The training substrate of the port (counterpart of ``repro/train``):
optimizers, gradient compression, checkpoints and the fault-tolerant
trainer."""
