"""The RWKV6 (Finch) WKV recurrence with a carried state (replaces the
TPU kernel in ``repro/kernels/wkv6/wkv6.py``)."""
