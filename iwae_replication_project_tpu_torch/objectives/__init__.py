"""Variational objectives (port of ``objectives/``)."""
