"""Fused scan->top-k search (replaces the TPU kernel in
``repro/kernels/sivf_scan/fused.py``)."""
