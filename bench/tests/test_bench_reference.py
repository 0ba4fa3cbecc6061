"""The plain reference against brute force, the comparison's rules on
hand-made answers, and the kernels' work counts on a hand-worked table."""
import numpy as np
import pytest
import torch

from bench.reference import ivf, judge
from bench.roofline import ivf_scan, peaks


def cloud(seed, n, d):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g)


def brute(q, x, cents, cb, codes, k, nprobe):
    """numpy float64: each query's probed lists by exact distance, then
    the exact top-k of the rows of those lists (ADC with codes)."""
    q, x, c = (t.double().numpy() for t in (q, x, cents))
    lists = ((x[:, None] - c[None]) ** 2).sum(-1).argmin(1)
    out_d, out_i = [], []
    for qi in q:
        probed = np.argsort(((qi - c) ** 2).sum(-1), kind="stable")[:nprobe]
        cand = np.nonzero(np.isin(lists, probed))[0]
        if cb is None:
            d = ((x[cand] - qi) ** 2).sum(-1)
        else:
            m = cb.shape[0]
            qs = qi.reshape(m, -1)
            t = ((qs[:, None] - cb.double().numpy()) ** 2).sum(-1)  # [m, K]
            d = t[np.arange(m), codes[cand].long().numpy()].sum(-1)
        o = np.argsort(d, kind="stable")[:k]
        out_d.append(np.pad(d[o], (0, k - len(o)), constant_values=np.inf))
        out_i.append(np.pad(cand[o], (0, k - len(o)), constant_values=-1))
    return np.array(out_d), np.array(out_i)


@pytest.mark.parametrize("pq", [False, True])
def test_reference_search_matches_brute_force(pq):
    x, q, cents = cloud(0, 600, 8), cloud(1, 9, 8), cloud(2, 12, 8)
    cb = cloud(3, 4 * 16 * 2, 1).reshape(4, 16, 2) if pq else None
    codes = ivf.encode(x, cb, "f64")["codes"] if pq else None
    lists = ivf.assign(x, cents, "f64")["list"]
    d, i = ivf.search(q, x, lists, cents, 7, 3, "f64", cb, codes, chunk=4)
    bd, bi = brute(q, x, cents, cb, codes, 7, 3)
    assert np.array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)
    if pq:   # the codes are each subspace's nearest codeword
        sub = ((x.double().reshape(600, 4, 1, 2) - cb.double()) ** 2).sum(-1)
        assert torch.equal(codes.long(), sub.argmin(-1))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0000002, 0.0])
    y = ivf.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 * 2 ** -10,
                          -3.0, 0.0]


def test_f32_answers_in_the_programs_place_pass_and_a_missed_row_fails():
    """The reference in float32 answers within the comparison's limits; a
    result that drops a due row does not."""
    x, q, cents = cloud(4, 800, 8), cloud(5, 16, 8), cloud(6, 10, 8)
    truth = judge.Truth(pool=x, centroids=cents,
                        assign=ivf.assign(x, cents, "f64"), codebooks=None,
                        encode=None, n_max=1 << 12, k=5, nprobe=3,
                        limits={"assign_gap": 1e-5, "dist_err": 1e-5})
    calls = [{"queries": q, "lo": 100, "hi": 800}]
    known, ans = judge.control_answers(truth, "f32", 100, 800, calls)
    r = judge.judge_call(truth, known, q, 100, 800, ans[0]["labels"],
                         ans[0]["dists"])
    assert r["search_wrong"] == 0 and r["dist_err"] < 1e-6
    lab = ans[0]["labels"].clone()
    lab[:, 0] = lab[:, 4]                        # a duplicate, a row missed
    r = judge.judge_call(truth, known, q, 100, 800, lab, ans[0]["dists"])
    assert r["search_wrong"] > 0
    lab = ans[0]["labels"].clone()
    lab[0, 0] = 50                               # a row removed before
    r = judge.judge_call(truth, known, q, 100, 800, lab, ans[0]["dists"])
    assert r["search_wrong"] > 0


def test_kernel_work_counts_on_a_hand_worked_table():
    # kernel 1: 1,000 rows of 96 floats and an id, 4 queries in, 4 x 10
    # results of a float and an int out
    assert ivf_scan.flat_bytes(1000, 4, 96, 10) == \
        1000 * (96 * 4 + 4) + 4 * 96 * 4 + 4 * 10 * 8 == 389_856
    assert ivf_scan.flat_flops(5000, 96) == 2 * 96 * 5000 == 960_000
    # kernel 2: 32 code bytes and an id a row, 4 ADC tables of 32 x 256
    # floats, the same results
    assert ivf_scan.pq_bytes(1000, 4, 32, 256, 10) == \
        1000 * 36 + 4 * 32 * 256 * 4 + 320 == 167_392
    assert ivf_scan.pq_lookups(5000, 32) == 160_000
    sxm = "NVIDIA H100 80GB HBM3"
    assert ivf_scan.least_seconds(3_350_000_000, 0, sxm) == 1e-3
    assert ivf_scan.least_seconds(0, 67_000_000_000, sxm) == 1e-3
    assert peaks.of("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    # the deep-10M cell's call: 86 % of 10M rows at 388 bytes, 1.0 ms
    s = ivf_scan.least_seconds(
        ivf_scan.flat_bytes(8_600_000, 1024, 96, 10),
        ivf_scan.flat_flops(1024 * 32 * 610, 96), sxm)
    assert 0.99e-3 < s < 1.0e-3


def test_pool_invariants_catch_a_slab_left_unreclaimed():
    c, nl = 32, 4
    planes = {
        "owner": torch.tensor([0, 0, 1, -1, -1], dtype=torch.int32),
        "live": torch.tensor([32, 5, 7, 0, 0], dtype=torch.int32),
        "bitmap": torch.tensor([[-1], [31], [127], [0], [0]],
                               dtype=torch.int32),
        "free_stack": torch.tensor([3, 4, 0, 0, 0], dtype=torch.int32),
        "free_top": torch.tensor(2, dtype=torch.int32),
        "tables": torch.tensor([[0, 1], [2, -1], [-1, -1], [-1, -1]],
                               dtype=torch.int32),
        "table_len": torch.tensor([2, 1, 0, 0], dtype=torch.int32),
        "heads": torch.tensor([1, 2, -1, -1], dtype=torch.int32),
        "n_live": torch.tensor(44, dtype=torch.int32)}
    assert judge.pool_violations(planes, c, nl) == 0
    planes["live"][1] = 0                        # emptied, still owned
    planes["bitmap"][1] = 0
    planes["n_live"] = torch.tensor(39, dtype=torch.int32)
    assert judge.pool_violations(planes, c, nl) > 0
