"""The Mamba (S6) selective scan with a carried state (replaces the TPU
kernel in ``repro/kernels/mamba_scan/mamba_scan.py``)."""
