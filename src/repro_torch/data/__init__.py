"""Deterministic synthetic data streams of the port (counterpart of
``repro/data``)."""
