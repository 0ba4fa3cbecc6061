"""The port's fused scan->top-k (plain version) against the JAX reference.

The same slab planes and tables go through the reference's plain
versions of its fused kernel, as the reference's own tests run it on the
CPU: the streaming XLA scan ``core.scan_slabs_topk`` and the unfused
oracle ``kernels.sivf_scan.ops.sivf_fused_search(impl="ref")``. (The
Pallas kernel's interpret mode does not run with the installed jax: it
names ``pltpu.TPUCompilerParams``, which that version no longer has.)
They also go through the port's ``sivf_fused_search`` on CPU tensors: its
plain version, the function the CUDA kernel is held to bit for bit on
the card. Labels ``==``; distances allclose(rtol=atol=1e-5), since the
port sums dot products in index order and the reference does not.
Tables stay tiny (Q <= 8, T <= 16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
from repro import core as jcore
from repro.kernels.sivf_scan import ops as jops
from repro_torch.kernels.sivf_scan import fused, ops, ref


def port_search(state, qs, table, k, metric):
    t = {name: torch.from_numpy(np.array(getattr(state, name)))
         for name in ("data", "ids", "norms")}
    bitmap = torch.from_numpy(np.array(state.bitmap).view(np.int32))
    d, lab = ops.sivf_fused_search(
        torch.from_numpy(qs), torch.from_numpy(np.array(table)), t["data"],
        t["ids"], t["norms"], bitmap, k, metric=metric)
    return d.numpy(), lab.numpy()


def assert_matches_reference(cfg, state, qs, k, nprobe, use_tables=True):
    lists = jcore.probe(state.centroids, jnp.asarray(qs), nprobe, cfg.metric)
    table = (jcore.gather_tables if use_tables else jcore.walk_chains)(
        cfg, state, lists)
    assert table.shape[0] <= 8 and table.shape[1] <= 16
    launches = fused.launches
    d, lab = port_search(state, qs, table, k, cfg.metric)
    assert fused.launches == launches           # CPU: the plain version
    for rd, rl in (
            jops.sivf_fused_search(
                jnp.asarray(qs), table, state.data, state.ids, state.norms,
                state.bitmap, k, metric=cfg.metric, impl="ref"),
            jcore.scan_slabs_topk(cfg, state, jnp.asarray(qs), table, k)):
        assert np.array_equal(lab, np.asarray(rl))
        np.testing.assert_allclose(d, np.asarray(rd), rtol=1e-5, atol=1e-5)
    return d, lab


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("capacity", [32, 64])
def test_matches_reference_scan(rng, metric, capacity):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=capacity, metric=metric,
                                   max_chain=8)
    state, _, _ = parity.load_rows(cfg, state, rng, 200)
    state = jcore.delete(cfg, state, jnp.arange(0, 200, 3, dtype=jnp.int32))
    qs = rng.normal(size=(5, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=7, nprobe=2,
                                      use_tables=metric == "l2")
    deleted = set(range(0, 200, 3))
    assert not deleted & set(lab.ravel().tolist())


def test_k_beyond_live_rows_pads_inf_and_minus_one(rng):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=32, max_chain=4)
    state, _, _ = parity.load_rows(cfg, state, rng, 6)
    qs = rng.normal(size=(3, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=20, nprobe=4)
    assert np.isinf(d[:, 6:]).all() and (lab[:, 6:] == -1).all()
    assert (lab[:, :6] >= 0).all()


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ties_keep_the_lowest_merge_index(rng, metric):
    """Duplicated vectors score identically in every implementation; the
    running entries and then the lowest slot must win."""
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=24,
                                   capacity=32, metric=metric, max_chain=4)
    v = rng.normal(size=(4, 16)).astype(np.float32)
    vecs = np.repeat(v, 12, axis=0)                    # 4 groups of 12
    state, _, _ = parity.load_rows(cfg, state, rng, 48, vecs=vecs,
                                   lists=np.zeros(48, np.int32))
    qs = np.concatenate([v[:2] + 0.01, rng.normal(size=(2, 16))]
                        ).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=16, nprobe=4)
    assert (d[0, :12] == d[0, 0]).all() and d[0, 12] > d[0, 0]
    assert lab[0, :12].tolist() == list(range(12))     # slot order wins


def test_empty_index_and_all_pad_table(rng):
    cfg, state = parity.make_state(rng, dim=16, n_lists=4, n_slabs=8,
                                   capacity=32, max_chain=4)
    qs = rng.normal(size=(2, 16)).astype(np.float32)
    d, lab = assert_matches_reference(cfg, state, qs, k=5, nprobe=4)
    assert np.isinf(d).all() and (lab == -1).all()


def test_cuda_route_refuses_cpu_tensors():
    q = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused.sivf_fused_search_cuda(
            q, torch.zeros((2, 3), dtype=torch.int32),
            torch.zeros((4, 32, 16)), torch.zeros((4, 32), dtype=torch.int32),
            torch.zeros((4, 32)), torch.zeros((4, 1), dtype=torch.int32), 5)


def test_dot_in_order_matches_sequential_sum(rng):
    q = rng.normal(size=(3, 7)).astype(np.float32)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    got = ref.dot_in_order(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    want = np.zeros((3, 5), np.float32)
    for i in range(7):
        want = want + q[:, i:i + 1] * x[:, :, i]
    assert np.array_equal(got, want)
