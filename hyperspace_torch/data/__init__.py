"""Graph data (counterpart of ``hyperspace_tpu.data``)."""
