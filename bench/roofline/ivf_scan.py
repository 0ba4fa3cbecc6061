"""The work of one fused scan->top-k call, counted from the reference's
view of the call: its queries' probed lists and the live rows in them.

A call needs each live row of the distinct lists its queries probe read
once (the payload and the id), its queries (raw) or ADC tables (PQ) read
once, and its results (a float32 distance and an int32 label, ``k`` a
query) written once, whatever the kernel reads again. A raw scan needs
``2 * dim`` FLOPs a pair of a query and a live row in one of its lists.
The counts follow ``chip_smoke.py:1500`` (kernel 1) and ``:1910``
(kernel 2), frozen here, without the slab headers and the slab table: the
call needs the rows, not the program's layout of them.
"""
from __future__ import annotations

from bench.roofline import peaks


def flat_bytes(rows: int, queries: int, dim: int, k: int) -> int:
    """Kernel 1: ``rows`` live rows of the distinct probed lists."""
    return rows * (4 * dim + 4) + queries * dim * 4 + queries * k * 8


def flat_flops(pairs: int, dim: int) -> int:
    """Kernel 1: ``pairs`` (query, live row of a probed list) pairs."""
    return 2 * dim * pairs


def pq_bytes(rows: int, queries: int, m: int, ksub: int, k: int) -> int:
    """Kernel 2: the rows' codes and ids, the ADC tables, the results."""
    return rows * (m + 4) + queries * m * ksub * 4 + queries * k * 8


def pq_lookups(pairs: int, m: int) -> int:
    """Kernel 2's table lookups (``m`` a pair); reported beside its share,
    not in it."""
    return pairs * m


def least_seconds(nbytes: int, flops: int, device_name: str) -> float:
    """The least time the card could take: bytes over the HBM rate or
    FLOPs over the float32 rate, whichever is larger."""
    p = peaks.of(device_name)
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["fp32_flops"])
