"""Checkpoints of the port: ``manager.CheckpointManager`` writes the same
files as the reference's ``repro/checkpoint/manager.py``."""
