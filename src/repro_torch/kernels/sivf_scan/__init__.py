"""Slab scans: the fused scan->top-k searches (replace the TPU kernels in
``repro/kernels/sivf_scan/fused.py`` and ``pq_fused.py``) and the unfused
scan (replaces ``repro/kernels/sivf_scan/sivf_scan.py``)."""
