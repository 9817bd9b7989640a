"""Benchmarks of the port (counterpart of ``hyperspace_tpu.benchmarks``)."""
