"""Training loops of the port (counterpart of ``hyperspace_tpu.train``)."""
