"""The program's kernels by the names the profiler gives their launches.

Kernel 1 (``src/repro_torch/csrc/sivf_fused_search.cu``) is, on its
``grouped`` route, the plan of ``slab_plan.cuh`` (a memset of its
counters, then ``plan_count``, ``plan_alloc``, ``plan_scatter``), the
scan and the merge; on its ``per_query`` route one kernel. Kernel 2
(``src/repro_torch/csrc/sivf_pq_fused_search.cu``) is its ``compacted``
scan or its ``per_query`` kernel. Together they are the fused
scan->top-k of a search call.

A kernel's own launches match by the whole demangled name: namespace,
template arguments and the head of the parameter list, so the unfused
scan of ``sivf_scan.cu``, whose kernel is also named
``grouped_scan_kernel`` (with one template argument and other
parameters), is not kernel 1. ``sivf_scan.cu`` uses the same plan, so the
plan's kernels and its memset count as kernel 1's only by their place:
the run of plan kernels that a kernel-1 scan directly follows, and the
memset directly before that run's ``plan_count``. Other memsets (the
probe's radix sort sets its own) are not kernel 1's.
"""
from __future__ import annotations

import re

_B = r"(?:true|false)"
KERNEL1_SCAN = re.compile(
    r"^(?:void )?\(anonymous namespace\)::(?:"
    rf"grouped_scan_kernel<{_B}, {_B}>\(float const\*, float const\*, "
    r"int const\*, float const\*"
    rf"|sivf_fused_search_kernel<{_B}, {_B}>\(float const\*, int const\*, "
    r"float const\*, int const\*)")
KERNEL1_MERGE = re.compile(
    r"^(?:void )?\(anonymous namespace\)::merge_kernel\(int const\*, int, "
    r"int, float const\*, int const\*, float\*, int\*, int\)")
PLAN = re.compile(r"^(?:void )?sivf::group::plan_(?:count|alloc|scatter)\(")
PLAN_COUNT = re.compile(r"^(?:void )?sivf::group::plan_count\(")
KERNEL2 = re.compile(
    r"^(?:void )?\(anonymous namespace\)::(?:"
    rf"compacted_scan_kernel<-?\d+, -?\d+, {_B}>"
    rf"|sivf_pq_fused_search_kernel<{_B}>)"
    r"\(float const\*, int const\*, unsigned char const\*")


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_memset(name: str) -> bool:
    return name.startswith("Memset")


def kernel1_mask(events: list) -> list[bool]:
    """Which of ``events`` (``(name, start, end)`` of one call, by start)
    are kernel 1's: its scan and merge by name, the plan and the plan's
    memset by their place before a kernel-1 scan."""
    names = [e[0] for e in events]
    mask = [bool(KERNEL1_SCAN.match(n) or KERNEL1_MERGE.match(n))
            for n in names]
    for i, n in enumerate(names):
        if not KERNEL1_SCAN.match(n):
            continue
        j = i - 1
        while j >= 0 and PLAN.match(names[j]):
            mask[j] = True
            j -= 1
        if (j >= 0 and j + 1 < i and is_memset(names[j])
                and PLAN_COUNT.match(names[j + 1])):
            mask[j] = True
    return mask


def kernel2_mask(events: list) -> list[bool]:
    """Which of ``events`` are kernel 2's."""
    return [bool(KERNEL2.match(e[0])) for e in events]


def scan_mask(events: list) -> list[bool]:
    """Kernel 1's or kernel 2's."""
    return [a or b for a, b in zip(kernel1_mask(events),
                                   kernel2_mask(events))]


def masked_ms(events: list, mask: list[bool]) -> float:
    """Device milliseconds of the events ``mask`` keeps."""
    return sum(e - s for (_, s, e), keep in zip(events, mask) if keep) / 1e6
