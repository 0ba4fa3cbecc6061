"""Row-wise k-smallest selection (replaces the TPU kernel in
``repro/kernels/topk/topk.py``)."""
