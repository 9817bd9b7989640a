"""Run telemetry of the port (counterpart of ``hyperspace_tpu.telemetry``):
the numerical-health monitor so far."""
