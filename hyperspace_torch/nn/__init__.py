"""Graph layers, scatters and decoders (counterpart of ``hyperspace_tpu.nn``)."""
