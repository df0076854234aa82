"""Telemetry (port of ``telemetry/``): the metric registry."""
