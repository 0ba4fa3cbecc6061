"""Kernel 1's and kernel 2's launches told apart from the others by the
names the profiler gives them, and kernel 1's plan by its place."""
from bench.lib import kernels

SCAN1 = ("void (anonymous namespace)::grouped_scan_kernel<true, false>("
         "float const*, float const*, int const*, float const*, int const*, "
         "int const*, int const*, int, int const*, int, int4 const*)")
PER_QUERY1 = ("void (anonymous namespace)::sivf_fused_search_kernel<false, "
              "false>(float const*, int const*, float const*, int const*, "
              "float const*, int const*)")
MERGE1 = ("(anonymous namespace)::merge_kernel(int const*, int, int, "
          "float const*, int const*, float*, int*, int)")
SCAN3 = ("void (anonymous namespace)::grouped_scan_kernel<true>(float const*, "
         "int const*, float const*, int const*, float const*, int const*)")
PLAN = [f"sivf::group::plan_{p}(int const*, long long)"
        for p in ("count", "alloc", "scatter")]
SCAN2 = ("void (anonymous namespace)::compacted_scan_kernel<8, 8, false>("
         "float const*, int const*, unsigned char const*, int const*)")
PER_QUERY2 = ("void (anonymous namespace)::sivf_pq_fused_search_kernel<true>"
              "(float const*, int const*, unsigned char const*, int const*)")
SORT = ("void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<float, "
        "long>(float const*)")
MEMSET = "Memset (Device)"
COPY = "Memcpy DtoH (Device -> Pinned)"


def ev(*names):
    return [(n, 10 * i, 10 * i + 1 + i) for i, n in enumerate(names)]


def test_kernel1_by_whole_name_and_its_plan_by_place():
    # the probe's sort with its own memset, then kernel 1's plan, scan,
    # merge, the copy
    e = ev(MEMSET, SORT, MEMSET, *PLAN, SCAN1, MERGE1, COPY)
    assert kernels.kernel1_mask(e) == [False, False, True, True, True,
                                       True, True, True, False]
    assert kernels.kernel2_mask(e) == [False] * len(e)
    want = sum(1 + i for i in range(2, 8))
    assert kernels.masked_ms(e, kernels.kernel1_mask(e)) == want / 1e6
    # the per_query route is one kernel
    assert kernels.kernel1_mask(ev(SORT, PER_QUERY1)) == [False, True]


def test_unfused_scan_and_its_plan_are_not_kernel1():
    # kernel 3 shares the scan's name and the plan: neither counts
    e = ev(MEMSET, *PLAN, SCAN3, COPY)
    assert kernels.kernel1_mask(e) == [False] * len(e)
    assert kernels.scan_mask(e) == [False] * len(e)


def test_kernel2_by_whole_name():
    e = ev(SORT, SCAN2, PER_QUERY2, MEMSET, COPY)
    assert kernels.kernel2_mask(e) == [False, True, True, False, False]
    assert kernels.scan_mask(e) == [False, True, True, False, False]
    assert kernels.kernel1_mask(e) == [False] * len(e)
