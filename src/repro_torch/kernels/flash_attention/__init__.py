"""Tiled attention with an online softmax, GQA, causal or not (replaces
the TPU kernel in ``repro/kernels/flash_attention/flash_attention.py``)."""
