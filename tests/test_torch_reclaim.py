"""Slab reclamation: the port's plain loop against the JAX delete.

The reference reclaims slabs inside ``_delete_impl``'s ``fori_loop`` over
every batch row. The port finds the reclaiming rows at once and runs only
their unlink / swap-with-last / push in order (``kernels/reclaim``; on
CPU tensors the plain loop ``reclaim_ref``). On reclaim-heavy batches
every integer plane must come out ``==`` to the reference's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import state as tst
from repro_torch.kernels.reclaim import ops as rops
from repro_torch.kernels.reclaim.reclaim import reclaim_cuda
from repro_torch.kernels.reclaim.ref import reclaim_ref

from test_torch_index import Twin


@pytest.fixture
def reclaim_counts(monkeypatch):
    """Record how many slabs each plain-loop call reclaims."""
    counts = []

    def counting(slabs, count, *planes):
        counts.append(int(count.reshape(())))
        reclaim_ref(slabs, count, *planes)

    monkeypatch.setattr(rops, "reclaim_ref", counting)
    return counts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reclaim_heavy_batches_match_reference(seed, reclaim_counts):
    rng = np.random.default_rng(seed)
    tw = Twin(rng, dim=8, n_lists=5, n_slabs=64, capacity=32, n_max=4096,
              max_chain=32)
    ids = np.arange(1500, dtype=np.int32)
    lists = rng.integers(0, 5, 1500).astype(np.int32)
    for lo in range(0, 1500, 500):
        tw.insert(rng.normal(size=(500, 8)), ids[lo:lo + 500],
                  lists[lo:lo + 500])
    # whole lists, in shuffled row order, with duplicates and absent ids
    for group in ((0, 3), (1,), (2, 4)):
        dels = ids[np.isin(lists, group)]
        dels = np.concatenate([dels, dels[:7], [-1, 5000, 4095]])
        tw.delete(rng.permutation(dels).astype(np.int32))
        live = np.isin(lists, group)
        lists[live] = -1
        tw.insert(rng.normal(size=(500, 8)),
                  np.arange(2000, 2500, dtype=np.int32) + 500 * len(group),
                  np.full(500, group[0], np.int32))
    assert sum(reclaim_counts) >= 30
    assert max(reclaim_counts) >= 10


def test_plain_loop_unlinks_and_swaps_in_order():
    """One list whose chain is 3 -> 1 -> 4 -> 0 (head 3); reclaim 1 then 3."""
    i32 = dict(dtype=torch.int32)
    heads = torch.tensor([3, -1], **i32)
    nxt = torch.tensor([-1, 4, -1, 1, 0, -1], **i32)
    prv = torch.tensor([4, 3, -1, -1, 1, -1], **i32)
    owner = torch.tensor([0, 0, -1, 0, 0, -1], **i32)
    cursor = torch.tensor([32, 32, 0, 5, 32, 0], **i32)
    free_stack = torch.tensor([2, 5, -7, -7, -7, -7], **i32)
    free_top = torch.tensor(2, **i32)
    tables = torch.tensor([[0, 4, 1, 3], [-1, -1, -1, -1]], **i32)
    table_len = torch.tensor([4, 0], **i32)
    table_pos = torch.tensor([0, 2, -1, 3, 1, -1], **i32)
    reclaim_ref(torch.tensor([1, 3, 9], **i32), torch.tensor([2], **i32),
                heads, nxt, prv, owner, cursor, free_stack, free_top,
                tables, table_len, table_pos)
    assert heads.tolist() == [4, -1]
    assert nxt.tolist() == [-1, -1, -1, -1, 0, -1]
    assert prv.tolist() == [4, -1, -1, -1, -1, -1]
    assert owner.tolist() == [0, -1, -1, -1, 0, -1]
    assert cursor.tolist() == [32, 0, 0, 0, 32, 0]
    assert free_stack.tolist() == [2, 5, 1, 3, -7, -7]
    assert int(free_top) == 4
    assert tables.tolist() == [[0, 4, -1, -1], [-1, -1, -1, -1]]
    assert table_len.tolist() == [2, 0]
    assert table_pos.tolist() == [0, -1, -1, -1, 1, -1]


def test_delete_reclaims_like_reference_loop(rng):
    """The vectorised reclaim mask: a slab emptied by several rows of one
    batch is reclaimed once, at its first row, as the reference's loop
    does; a slab that keeps a live row is not reclaimed."""
    tw = Twin(rng, dim=8, n_lists=2, n_slabs=8, capacity=32, n_max=256,
              max_chain=8)
    tw.insert(rng.normal(size=(96, 8)), np.arange(96),
              np.zeros(96, np.int32))
    tw.delete(np.array([40, 0, 70, 33, 1, 95] + list(range(2, 32))
                       + list(range(64, 70)), np.int32))
    assert int(tw.ts.free_top) == 8 - 3 + 1          # slab of ids 0..31
    assert int(tw.ts.live[int(tw.ts.att_slab[50])]) == 30


def test_cuda_route_refuses_cpu_tensors():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        reclaim_cuda(z, z[:1], z, z, z, z, z, z, z[0],
                     torch.zeros((2, 2), dtype=torch.int32), z, z)


def test_reclaim_count_stays_on_the_device(rng, monkeypatch):
    """The delete hands the count to the reclaim step as a tensor: no host
    read of it happens before the (plain or CUDA) reclaim runs."""
    seen = []
    monkeypatch.setattr(rops, "reclaim_ref",
                        lambda slabs, count, *p: seen.append(
                            (type(count), tuple(count.shape), slabs.dtype))
                        or reclaim_ref(slabs, count, *p))
    cfg = tst.SIVFConfig(dim=4, n_lists=1, n_slabs=4, capacity=32, n_max=64)
    st = tst.init_state(cfg, np.zeros((1, 4), np.float32), device="cpu")
    from repro_torch.core import index as tix
    st = tix.insert(cfg, st, torch.ones((40, 4)),
                    torch.arange(40, dtype=torch.int32))
    tix.delete(cfg, st, torch.arange(40, dtype=torch.int32))
    assert (torch.Tensor, (1,), torch.int32) in seen
