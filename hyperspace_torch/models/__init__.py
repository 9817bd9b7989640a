"""Models (counterpart of ``hyperspace_tpu.models``)."""
