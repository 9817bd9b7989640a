"""Command-line entry points (counterpart of ``hyperspace_tpu.cli``)."""
