"""Telemetry (port of ``telemetry/``): the metric registry, request tracing
with its flight recorder, and the SLO burn-rate monitor."""
