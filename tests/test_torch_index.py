"""Port insert / delete / search core against the JAX reference.

The same op sequence (inputs made with numpy from a seed) runs through
``repro.core`` and ``repro_torch.core`` (``device="cpu"``). After every op
all 23 planes must agree: integer planes and ``data`` ``==``, ``norms``
allclose(rtol=1e-6). Lists are routed once by the reference's ``assign``
and handed to both, so a near-tie in fp32 routing cannot fork the runs.
Search: labels ``==``, distances allclose(rtol=atol=1e-5).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.reference import ReferenceIndex
from repro_torch import interop
from repro_torch.core import index as tix
from repro_torch.core import state as tst

from test_torch_state import assert_planes_equal, jax_planes


class Twin:
    """One index in both packages, driven op by op and compared."""

    def __init__(self, rng, **kw):
        self.rng = rng
        self.jcfg = jcore.SIVFConfig(**kw)
        self.cfg = interop.config_from_dict(dataclasses.asdict(self.jcfg))
        self.cents = rng.normal(size=(self.cfg.n_lists, self.cfg.dim)
                                ).astype(np.float32)
        self.js = jcore.init_state(self.jcfg, jnp.asarray(self.cents))
        self.ts = tst.init_state(self.cfg, self.cents, device="cpu")
        self.ref = ReferenceIndex(self.cents, self.cfg.metric)

    def check(self):
        assert_planes_equal(jax_planes(self.js),
                            interop.state_to_numpy(self.ts))

    def insert(self, vecs, ids, lists=None):
        vecs = np.asarray(vecs, np.float32)
        ids = np.asarray(ids, np.int32)
        if lists is None:
            lists = np.array(jcore.assign(jnp.asarray(self.cents),
                                          jnp.asarray(vecs),
                                          self.cfg.metric))
        err0 = int(self.js.error)
        self.js = jcore.insert(self.jcfg, self.js, jnp.asarray(vecs),
                               jnp.asarray(ids), jnp.asarray(lists))
        self.ts = tix.insert(self.cfg, self.ts, torch.from_numpy(vecs),
                             torch.from_numpy(ids), torch.from_numpy(lists))
        self.check()
        new_err = int(self.js.error) & ~err0
        if not new_err & (tst.ERR_POOL_EXHAUSTED | tst.ERR_CHAIN_OVERFLOW):
            ok = (ids >= 0) & (ids < self.cfg.n_max)
            self.ref.insert(vecs[ok], ids[ok])
        return new_err

    def delete(self, ids):
        ids = np.asarray(ids, np.int32)
        self.js = jcore.delete(self.jcfg, self.js, jnp.asarray(ids))
        self.ts = tix.delete(self.cfg, self.ts, torch.from_numpy(ids))
        self.check()
        self.ref.delete([i for i in ids.tolist()
                         if 0 <= i < self.cfg.n_max])

    def live_ids(self) -> set:
        att = self.ts.att_slab.numpy()
        return set(np.nonzero(att >= 0)[0].tolist())


@pytest.mark.parametrize("capacity", [32, 64, 128])
def test_churn_planes_equal_reference(rng, capacity):
    """Overwrites, in-batch duplicates, out-of-range ids, slab reclaim;
    bit 31 of a bitmap word is set along the way."""
    tw = Twin(rng, dim=16, n_lists=4, n_slabs=40, capacity=capacity,
              n_max=700, max_chain=16)
    saw_bit31 = False
    for step in range(12):               # fixed shapes: -1 rows pad batches
        n = int(rng.integers(1, 90))
        ids = np.full(96, -1, np.int32)
        ids[:n] = rng.integers(-3, 760, n)               # dupes, -1, >n_max
        ids[: n // 4] = rng.integers(0, 40, n // 4)      # overwrites
        tw.insert(rng.normal(size=(96, 16)), ids)
        saw_bit31 |= bool((tw.js.bitmap >= np.uint32(1 << 31)).any())
        dels = np.full(128, -1, np.int32)
        m = int(rng.integers(1, 128))
        dels[:m] = rng.integers(-2, 760, m)
        tw.delete(dels)
        assert tw.live_ids() == set(tw.ref.store)
        assert int(tw.ts.n_live) == tw.ref.n_live
    assert saw_bit31


def test_duplicates_and_range_errors(rng):
    tw = Twin(rng, dim=8, n_lists=3, n_slabs=16, capacity=32, n_max=64,
              max_chain=8)
    vecs = rng.normal(size=(6, 8))
    err = tw.insert(vecs, [5, 5, -1, 64, -7, 5])          # last 5 wins
    assert err == tst.ERR_ID_RANGE
    assert tw.live_ids() == {5}
    slab, slot = int(tw.ts.att_slab[5]), int(tw.ts.att_slot[5])
    assert np.array_equal(tw.ts.data[slab, slot].numpy(),
                          vecs[5].astype(np.float32))
    tw.delete([5, 5, 5, -1, 99])                          # idempotent
    assert tw.live_ids() == set()


def test_pool_exhausted_batch_is_atomic(rng):
    tw = Twin(rng, dim=8, n_lists=4, n_slabs=6, capacity=32, n_max=512,
              max_chain=8)
    tw.insert(rng.normal(size=(128, 8)), np.arange(128),
              np.repeat(np.arange(4, dtype=np.int32), 32))   # 4 full slabs
    before = interop.state_to_numpy(tw.ts)
    # overwrites + new rows that need 4 slabs where 2 remain
    err = tw.insert(rng.normal(size=(128, 8)), np.arange(100, 228),
                    np.full(128, 2, np.int32))
    assert err & tst.ERR_POOL_EXHAUSTED
    after = interop.state_to_numpy(tw.ts)
    for name in tst.PLANES:
        if name != "error":
            assert np.array_equal(before[name], after[name]), name


def test_chain_overflow_batch_is_atomic(rng):
    tw = Twin(rng, dim=8, n_lists=2, n_slabs=32, capacity=32, n_max=512,
              max_chain=3)
    tw.insert(rng.normal(size=(70, 8)), np.arange(70),
              np.zeros(70, np.int32))
    err = tw.insert(rng.normal(size=(60, 8)), np.arange(40, 100),
                    np.zeros(60, np.int32))
    assert err == tst.ERR_CHAIN_OVERFLOW
    assert tw.live_ids() == set(range(70))


def test_reclaim_adjacent_slabs_of_one_chain(rng):
    """Empty three consecutive slabs of one list in one delete batch, in
    scrambled row order, then refill: unlink + swap-with-last in order."""
    tw = Twin(rng, dim=8, n_lists=2, n_slabs=16, capacity=32, n_max=512,
              max_chain=8)
    tw.insert(rng.normal(size=(160, 8)), np.arange(160),
              np.zeros(160, np.int32))                # 5 slabs, list 0
    tw.insert(rng.normal(size=(40, 8)), np.arange(200, 240),
              np.ones(40, np.int32))
    tw.delete(rng.permutation(np.arange(32, 128)))    # slabs 2-4 of chain
    assert int(tw.ts.table_len[0]) == 2
    tw.delete(np.concatenate([np.arange(0, 32), [201, 203]]))  # the head
    tw.insert(rng.normal(size=(100, 8)), np.arange(300, 400),
              np.zeros(100, np.int32))
    tw.delete(np.arange(0, 512))                      # everything
    assert int(tw.ts.free_top) == 16 and int(tw.ts.n_live) == 0


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("use_tables", [True, False])
def test_tables_and_search_match_reference(rng, metric, use_tables):
    tw = Twin(rng, dim=16, n_lists=6, n_slabs=48, capacity=32, n_max=2048,
              max_chain=8, metric=metric)
    for lo in range(0, 600, 150):
        tw.insert(rng.normal(size=(150, 16)), np.arange(lo, lo + 150))
    tw.delete(rng.choice(600, 200, replace=False))
    qs = rng.normal(size=(7, 16)).astype(np.float32)
    lists = np.array(jcore.probe(tw.js.centroids, jnp.asarray(qs), 3,
                                 metric))
    tl = torch.from_numpy(lists)
    for jf, tf in ((jcore.walk_chains, tix.walk_chains),
                   (jcore.gather_tables, tix.gather_tables)):
        assert np.array_equal(np.asarray(jf(tw.jcfg, tw.js,
                                            jnp.asarray(lists))),
                              tf(tw.cfg, tw.ts, tl).numpy())
    jd, jl = jcore.search(tw.jcfg, tw.js, jnp.asarray(qs), 5, 3,
                          use_tables=use_tables, impl="xla")
    td, tl_ = tix.search(tw.cfg, tw.ts, torch.from_numpy(qs), 5, 3,
                         use_tables=use_tables)
    assert np.array_equal(tl_.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    rd, rl = tw.ref.search(qs, 5, 3)
    assert np.array_equal(tl_.numpy(), rl)
    np.testing.assert_allclose(td.numpy(), rd, rtol=1e-5, atol=1e-5)


def test_stats_match_reference(rng):
    tw = Twin(rng, dim=8, n_lists=5, n_slabs=30, capacity=32, n_max=1024,
              max_chain=8)
    tw.insert(rng.normal(size=(300, 8)), np.arange(300))
    tw.delete(np.arange(0, 300, 4))
    ref = jcore.stats(tw.jcfg, tw.js)
    got = tix.stats(tw.cfg, tw.ts)
    assert got == pytest.approx(ref)
