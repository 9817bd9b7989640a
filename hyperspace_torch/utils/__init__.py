"""Utilities (counterpart of ``hyperspace_tpu.utils``)."""
