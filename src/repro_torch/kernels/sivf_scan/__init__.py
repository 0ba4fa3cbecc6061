"""Fused scan->top-k searches (replace the TPU kernels in
``repro/kernels/sivf_scan/fused.py`` and ``pq_fused.py``)."""
