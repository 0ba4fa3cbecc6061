"""One-token decode attention over a paged KV cache (replaces the TPU
kernel in ``repro/kernels/paged_attention/paged_attention.py``)."""
