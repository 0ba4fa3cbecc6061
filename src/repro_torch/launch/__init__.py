"""Launchers of the port (counterpart of ``repro/launch``): the
trainer, ``launch.train``."""
