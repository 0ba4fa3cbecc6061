"""The port's maintenance (split / merge / recluster) against the JAX
reference's, on the CPU.

  * ``plan_ops`` gives the reference's ops on the same occupancy, and
    ``MaintOp`` refuses what the reference's refuses;
  * after the same ops on states built by the same inserts (raw, PQ,
    filtered), every plane of the port's state is ``==`` the reference's,
    centroids included (``norms`` allclose 1e-6, summation order), and
    the reports are equal;
  * an aborted op leaves the state ``==`` what it was before; strict
    mode raises after every op resolves; the epoch bumps once per
    commit;
  * a tiered index maintains coherently (``==`` the all-resident one and
    the reference's tiered index); a deferred handle maintains between
    pending batches; ``maintain`` requires a trained index.
"""
import dataclasses

import numpy as np
import pytest

import parity
import sivf
import sivf_torch
from repro import core as jcore
from repro.core import maintenance as jmt
from repro_torch import interop
from repro_torch.core import maintenance as mt

from test_torch_pq import Twin
from test_torch_state import assert_planes_equal, jax_planes

D, NL = 16, 4


def rep_tuple(r):
    return dataclasses.astuple(r)


# ---------------------------------------------------------------------------
# Op construction + policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("occ,cursor,max_ops", [
    ([300, 2, 2, 40], 0, 2), ([40, 2, 2, 40], 0, 1), ([5, 5, 5, 5], 1, 2),
    ([5, 5, 5, 5], 3, 2), ([0, 0, 0, 0], 2, 2), ([0, 9, 0, 1, 300, 0], 4, 3),
    ([7], 0, 2), ([], 0, 2)])
def test_plan_ops_matches_reference(occ, cursor, max_ops):
    ops, cur = mt.plan_ops(occ, cursor, max_ops=max_ops)
    jops, jcur = jmt.plan_ops(occ, cursor, max_ops=max_ops)
    assert [(o.kind, o.lists) for o in ops] == \
        [(o.kind, o.lists) for o in jops]
    assert cur == jcur


def test_plan_ops_matches_reference_on_random_occupancy(rng):
    cursor = jcursor = 0
    for _ in range(20):
        occ = rng.integers(0, 50, 12) * rng.integers(0, 2, 12) ** 2
        occ[rng.integers(0, 12)] += int(rng.integers(0, 600))
        ops, cursor = mt.plan_ops(occ, cursor, max_ops=3)
        jops, jcursor = jmt.plan_ops(occ, jcursor, max_ops=3)
        assert [(o.kind, o.lists) for o in ops] == \
            [(o.kind, o.lists) for o in jops] and cursor == jcursor


def test_maintop_validation():
    assert mt.split(0, 1).lists == (0, 1) and mt.recluster(3).lists == (3,)
    for make, msg in ((lambda m: m.MaintOp("defrag", (0,)),
                       "unknown maintenance kind"),
                      (lambda m: m.MaintOp("recluster", (0, 1)),
                       "takes 1 list"),
                      (lambda m: m.MaintOp("split", (0,)), "takes 2 list"),
                      (lambda m: m.merge(2, 2), "distinct")):
        for m in (mt, jmt):
            with pytest.raises(ValueError, match=msg):
                make(m)
    assert mt.maint_batch_size(sivf_torch.SIVFConfig(
        dim=D, n_lists=NL, n_slabs=24, capacity=32, n_max=2048,
        max_chain=8)) == 512


# ---------------------------------------------------------------------------
# The functional core: planes == the reference's after each op
# ---------------------------------------------------------------------------

OPS = [mt.recluster(0), mt.split(1, 2), mt.merge(0, 3), mt.recluster(2),
       mt.merge(2, 1), mt.split(3, 0)]


@pytest.mark.parametrize("kind", ["raw", "pq", "ip"])
def test_ops_give_the_reference_planes(rng, kind):
    """Six ops in a row (each list touched, one merge onto a list a split
    refilled), after inserts and deletes: planes ``==``, centroids
    included, and reports equal after every op."""
    tw = Twin(rng, m=4 if kind == "pq" else None,
              metric="ip" if kind == "ip" else "l2")
    tw.fill(rng, 4)
    tw.delete(np.pad(np.arange(0, 150, 4), (0, 64 - 38),
                     constant_values=-1))
    for op in OPS:
        jop = jmt.MaintOp(op.kind, op.lists)
        tw.js, jrep = jcore.maintain(tw.jcfg, tw.js, jop)
        tw.ts, trep = mt.maintain(tw.cfg, tw.ts, op)
        assert rep_tuple(trep) == rep_tuple(jrep)
        assert trep.committed and trep.rows > 0
        tw.check()                    # every plane, centroids included
    assert int(tw.ts.n_live) == 256 - 38


def test_plan_op_and_gather_match_reference(rng):
    """The gather (ids, vectors, codes, attrs, source lists) and the host
    refinement give the reference's arrays ``==``."""
    tw = Twin(rng, m=8, nbits=5)
    tw.fill(rng, 3)
    for op in (mt.split(0, 1), mt.merge(2, 3), mt.recluster(1)):
        jop = jmt.MaintOp(op.kind, op.lists)
        g = mt.gather_live(tw.cfg, tw.ts, mt.shard_views(tw.cfg, tw.ts),
                           op.lists)
        jg = jmt.gather_live(tw.jcfg, tw.js, jmt.shard_views(tw.jcfg, tw.js),
                             jop.lists)
        for key in ("ids", "vecs", "codes", "attrs", "lists"):
            assert np.array_equal(g[key], jg[key]), key
        cents = tw.ts.centroids.numpy()
        p, jp = mt.plan_op(tw.cfg, op, g, cents), jmt.plan_op(
            tw.jcfg, jop, jg, np.asarray(tw.js.centroids))
        assert np.array_equal(p[0], jp[0]) and np.array_equal(p[1], jp[1])
        b = mt.pad_batch(tw.cfg, g, p[1], mt.maint_batch_size(tw.cfg))
        jb = jmt.pad_batch(tw.jcfg, jg, jp[1], jmt.maint_batch_size(tw.jcfg))
        for key in b:
            assert np.array_equal(b[key], jb[key]), key


def test_no_op_on_empty_lists(rng):
    tw = Twin(rng)
    tw.insert(rng.normal(size=(64, D)), np.arange(64),
              np.zeros((64, 2)), lists=np.zeros(64, np.int32))
    before = interop.state_to_numpy(tw.ts)
    tw.ts, rep = mt.maintain(tw.cfg, tw.ts, mt.merge(2, 3))
    assert rep_tuple(rep) == ("merge", (2, 3), 0, True, 0, 64)
    assert_planes_equal(before, interop.state_to_numpy(tw.ts))


# ---------------------------------------------------------------------------
# Atomicity, strict mode, epochs: the session surface
# ---------------------------------------------------------------------------

_TIGHT = dict(dim=D, n_lists=NL, n_slabs=12, capacity=32, n_max=2048,
              max_chain=2)


def _tight_pair(rng):
    """A reference and a port handle whose 2-slab chain bound makes
    merge(0, 1) of 100 rows overflow (``tests/test_maintenance.py``)."""
    cents = (rng.normal(size=(NL, D)) * 4.0).astype(np.float32)
    vecs = (cents[np.arange(200) % NL] +
            0.1 * rng.normal(size=(200, D))).astype(np.float32)
    j = sivf.Index(sivf.SIVFConfig(**_TIGHT), cents, min_bucket=8)
    t = sivf_torch.Index(sivf_torch.SIVFConfig(**_TIGHT), cents,
                         device="cpu", min_bucket=8)
    for x in (j, t):
        assert x.add(vecs, np.arange(200, dtype=np.int32)).ok
    return j, t, vecs


def _all_live_searchable(idx, vecs):
    d, lab = idx.search(vecs, 1, NL)
    assert (np.asarray(lab)[:, 0] == np.arange(len(vecs))).all()
    np.testing.assert_allclose(np.asarray(d)[:, 0], 0, atol=1e-4)


def test_aborted_op_changes_nothing(rng):
    j, t, vecs = _tight_pair(rng)
    before = interop.state_to_numpy(t.state)
    before = {k: v.copy() for k, v in before.items()}
    e0 = t.epoch
    rj = j.maintain(ops=[jmt.merge(0, 1)], strict=False)[0]
    rt = t.maintain(ops=[mt.merge(0, 1)], strict=False)[0]
    assert rep_tuple(rt) == rep_tuple(rj) and not rt.committed
    assert rt.errors & mt.ABORT_BITS
    assert_planes_equal(before, interop.state_to_numpy(t.state))
    assert_planes_equal(jax_planes(j.state), interop.state_to_numpy(t.state))
    assert t.epoch == e0 and t.n_live == 200
    _all_live_searchable(t, vecs)
    more = np.random.default_rng(3).normal(size=(8, D)).astype(np.float32)
    assert t.add(more, np.arange(300, 308, dtype=np.int32)).ok


def test_strict_mode_raises_after_all_ops_resolve(rng):
    j, t, vecs = _tight_pair(rng)
    with pytest.raises(sivf_torch.MaintenanceAborted) as et:
        t.maintain(ops=[mt.merge(0, 1), mt.recluster(2)], strict=True)
    with pytest.raises(sivf.MaintenanceAborted) as ej:
        j.maintain(ops=[jmt.merge(0, 1), jmt.recluster(2)], strict=True)
    assert rep_tuple(et.value.report) == rep_tuple(ej.value.report)
    assert str(et.value) == str(ej.value)
    # the recluster after the aborted merge ran: the epoch moved once
    assert t.epoch == j.epoch == 2
    assert_planes_equal(jax_planes(j.state), interop.state_to_numpy(t.state))
    _all_live_searchable(t, vecs)


def _handles(rng, **kw):
    base = dict(dim=D, n_lists=NL, n_slabs=48, capacity=32, n_max=4096,
                max_chain=12)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    j = sivf.Index(sivf.SIVFConfig(**base, **kw), cents, min_bucket=8)
    t = sivf_torch.Index(sivf_torch.SIVFConfig(**base, **kw), cents,
                         device="cpu", min_bucket=8)
    return j, t


def test_policy_sweeps_bump_the_epoch_per_commit(rng):
    j, t = _handles(rng)
    vecs = rng.normal(size=(300, D)).astype(np.float32)
    for x in (j, t):
        x.add(vecs, np.arange(300, dtype=np.int32))
    for sweep in range(3):
        e0 = t.epoch
        rj, rt = j.maintain(max_ops=2), t.maintain(max_ops=2)
        assert [rep_tuple(r) for r in rt] == [rep_tuple(r) for r in rj]
        moved = sum(1 for r in rt if r.committed and r.rows > 0)
        assert t.epoch == e0 + moved == j.epoch
        assert len(t.last_maintain_ms) == len(rt)
        assert set(t.last_maintain_ms[0]) == {"gather", "plan", "commit"}
    assert t._maint_cursor == j._maint_cursor
    assert_planes_equal(jax_planes(j.state), interop.state_to_numpy(t.state))
    _all_live_searchable(t, vecs)


def test_tiered_maintenance_stays_coherent(rng):
    """The port's tiered index after churn and maintenance: metadata
    planes ``==`` its all-resident twin's and the reference's tiered
    index's, host store ``==`` the twin's payload planes, searches
    ``==`` (filtered too); it keeps ingesting afterwards."""
    kw = dict(attributes=("tenant",))
    jt, t = _handles(rng, device_slabs=40, **kw)
    f = sivf_torch.Index(dataclasses.replace(t.cfg, device_slabs=None),
                         t.state.centroids.numpy(), device="cpu",
                         min_bucket=8)
    vecs = rng.normal(size=(500, D)).astype(np.float32)
    ids = np.arange(500, dtype=np.int32)
    parity.twin_churn(rng, (jt, t, f), vecs, ids,
                      attrs={"tenant": ids % 3},
                      attrs_fn=lambda n: {"tenant": np.arange(n) % 3})
    qs = rng.normal(size=(5, D)).astype(np.float32)
    t.search(qs, 10, 2)                  # frames resident before the ops
    jt.search(qs, 10, 2)
    for op in (mt.recluster(0), mt.merge(1, 2), mt.split(0, 3)):
        jop = jmt.MaintOp(op.kind, op.lists)
        rt = t.maintain(ops=[op], strict=True)
        rf = f.maintain(ops=[op], strict=True)
        rj = jt.maintain(ops=[jop], strict=True)
        assert rep_tuple(rt[0]) == rep_tuple(rf[0]) == rep_tuple(rj[0])
        pt = interop.state_to_numpy(t.state)
        pf = interop.state_to_numpy(f.state)
        for name in pt:
            if name not in ("data", "codes", "attrs"):
                assert np.array_equal(pt[name], pf[name]), name
        st = t._tiered.store
        assert np.array_equal(st.data, pf["data"])
        assert np.array_equal(st.attrs, pf["attrs"])
        for kw_ in ({}, {"filter": sivf_torch.Eq("tenant", 1)}):
            parity.assert_results_same(t.search(qs, 10, NL, **kw_),
                                       f.search(qs, 10, NL, **kw_))
        jt.search(qs, 10, NL)
        assert t.stats()["cache_uploads"] == jt.stats()["cache_uploads"]
    more = rng.normal(size=(16, D)).astype(np.float32)
    for x in (t, f):
        x.add(more, np.arange(3000, 3016, dtype=np.int32),
              attrs={"tenant": 1})
    parity.assert_results_same(t.search(qs, 10, NL), f.search(qs, 10, NL))


def test_deferred_handle_maintains_between_pending(rng):
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=NL, n_slabs=48, capacity=32,
                                n_max=2048, max_chain=12)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    deferred = sivf_torch.Index(cfg, cents, device="cpu", min_bucket=8,
                                deferred=True)
    vecs = rng.normal(size=(120, D)).astype(np.float32)
    fut = deferred.add(vecs, np.arange(120, dtype=np.int32))
    reps = deferred.maintain(ops=[mt.recluster(0)], strict=False)
    assert all(isinstance(r, mt.MaintenanceReport) for r in reps)
    assert reps[0].committed and reps[0].rows > 0
    assert not fut.done
    deferred.flush()
    assert fut.result().ok and deferred.n_live == 120
    _all_live_searchable(deferred, vecs)


def test_maintain_requires_trained(rng):
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=NL, n_slabs=8, capacity=32,
                                pq=sivf_torch.PQConfig(m=4, nbits=4))
    idx = sivf_torch.Index(cfg, rng.normal(size=(NL, D)).astype(np.float32),
                           device="cpu")
    with pytest.raises(RuntimeError, match="untrained"):
        idx.maintain(ops=[mt.recluster(0)])
    assert isinstance(sivf_torch.split(0, 1), sivf_torch.MaintOp)
    assert sivf_torch.MaintenanceReport is mt.MaintenanceReport
