"""Sharding plans of the port: one device, no mesh (``rules.py``)."""
