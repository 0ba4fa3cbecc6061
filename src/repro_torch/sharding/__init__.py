"""Sharding of the LM over a model mesh: logical axes (``axes.py``) and
the per-(arch, mesh, shape) plan with its padding (``rules.py``)."""
