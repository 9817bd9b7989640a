"""Optimizers of the port (counterpart of ``hyperspace_tpu.optim``)."""
