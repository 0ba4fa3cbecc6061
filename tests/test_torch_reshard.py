"""Elastic resharding, persistence, maintenance and serving on a mesh of
the port, against the JAX reference, on the CPU.

  * a live handle resharded 1 -> 4 -> 2 -> 3 -> 1 keeps its canonical
    live-row table and its search results ``==`` (ids and distances: the
    stored bytes are re-routed, never recomputed), every id on the shard
    ``id % S`` picks, and it keeps streaming; a deferred queue flushes
    first;
  * checkpoints cross shard counts and packages: the port's 4-shard save
    loads onto 4 (planes ``==``), 3, 2, 1 shards and ``"single"``
    (searches ``==``), and into the reference onto ``"single"`` (planes
    ``==`` the port's own collapse); a reference mesh checkpoint (its
    ``reshard_state(stack=True)`` written by its ``CheckpointManager``
    with a mesh sidecar) loads into the port onto 1-4 shards (planes
    ``==`` on 4, searches ``==`` the reference's ``search_stacked``);
    the reference's load errors;
  * maintenance on a mesh: after split / merge / recluster every shard's
    planes, centroids included, ``==`` an oracle built from the
    reference's gather, plan and single-backend ``_insert_impl`` per shard
    with its vote (``repro/core/distributed.py:160-228``); one shard's
    abort reverts every shard and ``shard_errors`` names it;
  * a tiered mesh: every shard's planes, host store, residency maps and
    frames as the reference's tiered index per shard, the counters their
    sums, results ``==`` the all-resident mesh; save, load, reshard
    (counters carried) and maintenance;
  * a ``ServeEngine`` over a mesh index: coalesced tiles ``==`` direct
    searches.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import distributed as jdist
from repro.core import index as jix
from repro.core import maintenance as jmt
from repro.core import state as jstate
from repro_torch import interop
from repro_torch.core import distributed as dist
from repro_torch.core import maintenance as mt
from repro_torch.core.state import PLANES
from repro.kernels.topk.ref import topk_ref as jtopk_ref

from test_torch_distributed import (B, D, NL, PQ_CASES, Oracle, assert_search,
                                    assert_tables_equal, cfgs, codebooks,
                                    mesh, pad, share_adc)
from test_torch_state import assert_planes_equal, jax_planes


def churned(rng, tcfg, backend="single", n=300, **kw):
    """A port handle after adds, removes and overwrites (PQ trained)."""
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    idx = sivf_torch.Index(tcfg, cents, backend=backend, min_bucket=16,
                           device=None if backend != "single" else "cpu",
                           **kw)
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    if tcfg.pq is not None:
        idx.train(vecs, generator=torch.Generator().manual_seed(1))
    attrs = {"attrs": (np.arange(n) % 3)[:, None]} if tcfg.n_attrs else {}
    idx.add(vecs, np.arange(n), **attrs)
    idx.remove(np.arange(0, n, 7))
    a10 = {"attrs": attrs["attrs"][:10]} if attrs else {}
    idx.add(vecs[:10] + 0.25, np.arange(10), **a10)         # overwrites
    return idx, vecs


def results(idx, qs, k=5, nprobe=NL):
    d, lab = idx.search(qs, k, nprobe)
    return d.numpy(), lab.numpy()


@pytest.mark.parametrize("case", sorted(PQ_CASES))
def test_live_reshard_chain_is_search_identical(rng, case):
    _, tcfg = cfgs(PQ_CASES[case])
    idx, vecs = churned(rng, tcfg)
    qs = rng.normal(size=(6, D)).astype(np.float32)
    d0, l0 = results(idx, qs)
    rows0 = dist.flatten_live_rows(tcfg, idx.state)
    for n_to in (4, 2, 3, 1):
        idx.reshard(mesh(n_to))
        assert idx.backend == "mesh" and idx.n_shards == n_to
        d, lab = results(idx, qs)
        assert np.array_equal(d, d0) and np.array_equal(lab, l0), n_to
        assert_tables_equal(dist.flatten_live_rows(tcfg, idx.state), rows0)
        for s in range(n_to):
            ids = dist.flatten_live_rows(tcfg, idx.state[s])["ids"]
            assert (ids % n_to == s).all()
    idx.reshard("single")
    assert idx.backend == "single" and idx.n_shards == 1
    assert np.array_equal(results(idx, qs)[1], l0)
    # streaming goes on after a reshard, onto the owning shard
    idx.reshard(mesh(3))
    nv = rng.normal(size=(4, D)).astype(np.float32) * 3.0 + 10.0
    rep = idx.add(nv, np.arange(2000, 2004))
    assert rep.ok and rep.accepted == 4
    live = np.asarray(sorted((set(range(300)) - set(range(0, 300, 7)))
                             | set(range(10)) | set(range(2000, 2004))))
    assert idx.stats()["per_shard_live"] == \
        np.bincount(live % 3, minlength=3).tolist()
    if tcfg.pq is None:
        assert results(idx, nv, 1)[1][:, 0].tolist() == list(range(2000,
                                                                   2004))
    assert idx.remove(np.arange(2000, 2004)).accepted == 4


def test_live_reshard_flushes_deferred_queue(rng):
    _, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    idx = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=16,
                           deferred=True)
    vecs = rng.normal(size=(30, D)).astype(np.float32)
    fut = idx.add(vecs, np.arange(30))
    assert not fut.done
    idx.reshard(mesh(1))
    assert fut.done and fut.result().accepted == 30
    assert idx.backend == "mesh" and idx.n_live == 30
    fut2 = idx.add(vecs, np.arange(100, 130))
    assert idx.flush() == [fut2.result()]
    assert fut2.result().shard_errors == (sivf_torch.ErrorCode.NONE,)


# ---------------------------------------------------------------------------
# Checkpoints across shard counts and packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["raw", "pq"])
def test_port_mesh_checkpoint_loads_anywhere(rng, tmp_path, case,
                                             monkeypatch):
    jcfg, tcfg = cfgs(PQ_CASES[case], ("tenant",))
    idx, _ = churned(rng, tcfg, mesh(4))
    qs = rng.normal(size=(6, D)).astype(np.float32)
    d0, l0 = results(idx, qs)
    idx.save(tmp_path)
    side = json.loads((tmp_path / "index.json").read_text())
    assert (side["backend"], side["n_shards"], side["routing"]) == \
        ("mesh", 4, {"rule": "mod", "n_shards": 4, "axis": "data"})
    same = sivf_torch.Index.load(tmp_path, backend=mesh(4))
    for s in range(4):
        assert_planes_equal(interop.state_to_numpy(idx.state[s]),
                            interop.state_to_numpy(same.state[s]))
    with pytest.raises(ValueError, match="pass backend="):
        sivf_torch.Index.load(tmp_path, device="cpu")
    for tgt, n in ((mesh(2), 2), (mesh(3), 3), (mesh(1), 1),
                   ("single", 1)):
        m = sivf_torch.Index.load(tmp_path, backend=tgt, device="cpu")
        assert m.n_shards == n and m.n_live == idx.n_live
        d, lab = results(m, qs)
        assert np.array_equal(d, d0) and np.array_equal(lab, l0), tgt
        assert m.stats()["list_occupancy"] == idx.stats()["list_occupancy"]
    # the reference opens the port's 4-shard checkpoint onto one device:
    # its collapse and the port's are the same planes
    if tcfg.pq is not None:
        share_adc(monkeypatch)
    j = sivf.Index.load(tmp_path, backend="single")
    assert_planes_equal(jax_planes(j.state), interop.state_to_numpy(m.state))
    jd, jl = j.search(qs, 5, NL)
    assert_search(m.search(qs, 5, NL), (np.asarray(jd), np.asarray(jl)),
                  tcfg.pq is not None)


def reference_mesh_checkpoint(rng, path, jcfg, n_shards=4):
    """A reference checkpoint of ``n_shards`` shards without a reference
    mesh: its single index churned, ``reshard_state(stack=True)`` written
    by its ``CheckpointManager`` under its own sidecar, marked mesh."""
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    j = sivf.Index(jcfg, cents, min_bucket=16)
    vecs = rng.normal(size=(200, D)).astype(np.float32)
    if jcfg.pq is not None:
        j.train(vecs, key=jax.random.key(2))
    attrs = {"attrs": (np.arange(200) % 3)[:, None]} if jcfg.attributes \
        else {}
    j.add(vecs, np.arange(200), **attrs)
    j.remove(np.arange(0, 200, 5))
    j.save(path)
    stacked = jdist.reshard_state(jcfg, j.state, 1, n_shards, stack=True)
    mgr = JManager(path, keep_last=1)
    meta = mgr.load_metadata("index")
    meta.update(backend="mesh", n_shards=n_shards,
                routing={"rule": "mod", "n_shards": n_shards,
                         "axis": "data"})
    mgr.save_metadata("index", meta)
    mgr.save(0, stacked)
    return stacked


@pytest.mark.parametrize("case", ["raw", "pq_store_raw"])
def test_reference_mesh_checkpoint_loads_into_the_port(rng, tmp_path, case,
                                                       monkeypatch):
    jcfg, tcfg = cfgs(PQ_CASES[case], ("tenant",))
    stacked = reference_mesh_checkpoint(rng, tmp_path, jcfg)
    if tcfg.pq is not None:
        share_adc(monkeypatch)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    jd, jl = jdist.search_stacked(jcfg, stacked, pad(qs, 16), 5, NL)
    want = (np.asarray(jd)[:5], np.asarray(jl)[:5])
    four = sivf_torch.Index.load(tmp_path, backend=mesh(4))
    for s in range(4):
        assert_planes_equal(jax_planes(jax.tree.map(lambda x: x[s],
                                                    stacked)),
                            interop.state_to_numpy(four.state[s]))
    assert_search(four.search(qs, 5, NL), want, tcfg.pq is not None)
    rows = jdist.flatten_live_rows(jcfg, stacked)
    for tgt in (mesh(3), mesh(2), mesh(1), "single"):
        m = sivf_torch.Index.load(tmp_path, backend=tgt, device="cpu")
        assert_tables_equal(dist.flatten_live_rows(tcfg, m.state), rows)
        assert_search(m.search(qs, 5, NL), want, tcfg.pq is not None)


def test_load_errors_are_the_references(rng, tmp_path):
    """A sharded checkpoint without ``backend=``, an unknown routing rule,
    a mesh without the data axis, a bad backend, and a sidecar claiming
    shards the planes do not have: the reference's errors."""
    jcfg, tcfg = cfgs()
    idx, _ = churned(rng, tcfg, n=40)
    idx.save(tmp_path / "c")
    with pytest.raises(ValueError, match="axis"):
        sivf_torch.Index.load(tmp_path / "c", device="cpu",
                              backend=sivf_torch.ShardMesh.virtual(
                                  1, "cpu", axis="model"))
    with pytest.raises(TypeError, match="backend"):
        sivf_torch.Index.load(tmp_path / "c", backend=3)
    side = tmp_path / "c" / "index.json"
    meta = json.loads(side.read_text())
    side.write_text(json.dumps({**meta, "routing": {"rule": "rendezvous"}}))
    for load in (lambda: sivf.Index.load(tmp_path / "c"),
                 lambda: sivf_torch.Index.load(tmp_path / "c",
                                               device="cpu")):
        with pytest.raises(ValueError, match="routing rule 'rendezvous'"):
            load()
    side.write_text(json.dumps({**meta, "backend": "single",
                                "n_shards": 4}))
    with pytest.raises(ValueError) as ej:
        sivf.Index.load(tmp_path / "c")
    with pytest.raises(ValueError) as et:
        sivf_torch.Index.load(tmp_path / "c", device="cpu")
    assert str(et.value) == str(ej.value)          # "... but n_from=4"


# ---------------------------------------------------------------------------
# Maintenance on a mesh
# ---------------------------------------------------------------------------

jinsert = jax.jit(jix._insert_impl, static_argnums=0)


class MaintOracle(Oracle):
    """The reference's mesh maintenance from its host gather and plan and
    its single-backend ``_insert_impl`` per shard, with the vote."""

    def maintain(self, op):
        st = self.stacked()
        views = jmt.shard_views(self.jcfg, st)
        gathered = jmt.gather_live(self.jcfg, st, views, op.lists)
        plan = jmt.plan_op(self.jcfg, op, gathered,
                           np.asarray(st.centroids)[0])
        if plan is None:
            return None
        new_cents, lists = plan
        batch = jmt.pad_batch(self.jcfg, gathered, lists,
                              jmt.maint_batch_size(self.jcfg, self.n))
        ids = batch["ids"]
        outs, errs = [], []
        for s in range(self.n):
            st0 = jstate.clear_error(self.sts[s])
            staged = dataclasses.replace(st0,
                                         centroids=jnp.asarray(new_cents))
            mine = np.where((ids >= 0) & (ids % self.n == s), ids, -1)
            out = jinsert(self.jcfg, staged, jnp.asarray(batch["vecs"]),
                          jnp.asarray(mine), jnp.asarray(batch["lists"]),
                          None if batch["codes"] is None
                          else jnp.asarray(batch["codes"]),
                          None if batch["attrs"] is None
                          else jnp.asarray(batch["attrs"]))
            outs.append(out)
            errs.append(int(out.error))
        if not any(e & jmt.ABORT_BITS for e in errs):
            self.sts = [jstate.clear_error(o) for o in outs]
        return errs


@pytest.mark.parametrize("case", ["raw", "pq"])
def test_mesh_maintenance_matches_the_reference(rng, case):
    """Split, merge and recluster on 3 shards (and a policy sweep): every
    shard's planes, centroids included, ``==`` the oracle's after each
    op; reports agree with a single index maintained alike."""
    jcfg, tcfg = cfgs(PQ_CASES[case], ("tenant",), n_slabs=32)
    cents = (rng.normal(size=(NL, D)) * 3).astype(np.float32)
    cb = codebooks(rng, tcfg)
    oracle = MaintOracle(jcfg, cents, 3, cb)
    m = sivf_torch.Index(tcfg, cents, backend=mesh(3), min_bucket=B,
                         pq_codebooks=cb)
    single = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=B,
                              pq_codebooks=cb)
    pattern = rng.permuted(np.repeat(np.arange(NL), [60, 6, 6, 30, 30, 20,
                                                     20, 20]))
    vecs = (cents[pattern] + 0.3 * rng.normal(size=(192, D))).astype(
        np.float32)
    for lo in range(0, 192, B):
        ids = np.arange(lo, lo + B)
        at = (ids % 3)[:, None].astype(np.int32)
        m.add(vecs[ids], ids, attrs=at)
        single.add(vecs[ids], ids, attrs=at)
        oracle.add(vecs[ids], ids, at)
    m.remove(np.arange(0, 192, 9))
    single.remove(np.arange(0, 192, 9))
    oracle.remove(pad(np.arange(0, 192, 9), B, -1))
    for op in (mt.split(0, 1), mt.merge(1, 2), mt.recluster(3)):
        (rm,), (rs,) = m.maintain([op]), single.maintain([op])
        assert dataclasses.astuple(rm) == dataclasses.astuple(rs)
        assert rm.committed
        assert oracle.maintain(jmt.MaintOp(op.kind, op.lists)) == [0, 0, 0]
        oracle.check(m.state)
    reps_m, reps_s = m.maintain(max_ops=2), single.maintain(max_ops=2)
    assert [dataclasses.astuple(r) for r in reps_m] == \
        [dataclasses.astuple(r) for r in reps_s]
    for s in range(1, 3):
        assert torch.equal(m.state[s].centroids, m.state[0].centroids)
    assert torch.equal(m.state[0].centroids, single.state.centroids)
    assert m.epoch == single.epoch


def test_one_shards_abort_reverts_every_shard(rng):
    """Shard 0 holds most of lists 0 and 1, so ``merge(0, 1)`` overflows
    its chain bound while shard 1 would fit: no shard commits, every
    shard's planes stay ``==`` what they were, and ``shard_errors`` names
    shard 0."""
    jcfg, tcfg = cfgs(n_slabs=12, max_chain=2)
    cents = (rng.normal(size=(NL, D)) * 4).astype(np.float32)
    m = sivf_torch.Index(tcfg, cents, backend=mesh(2), min_bucket=B)
    lists = np.repeat([0, 1, 2, 3], [50, 50, 10, 10])
    ids = np.where(lists < 2, 2 * np.arange(120), 2 * np.arange(120) + 1)
    vecs = (cents[lists] + 0.1 * rng.normal(size=(120, D))).astype(
        np.float32)
    assert m.add(vecs, ids).ok
    before = [interop.state_to_numpy(sh) for sh in m.state.shards]
    views = mt.shard_views(tcfg, m.state)
    gathered = mt.gather_live(tcfg, m.state, views, (0, 1))
    new_cents, rl = mt.plan_op(tcfg, mt.merge(0, 1), gathered,
                               m.state[0].centroids.numpy())
    batch = mt.pad_batch(tcfg, gathered, rl, mt.maint_batch_size(tcfg, 2))
    st, aux = mt._commit_op_mesh(tcfg, m._mesh, "data", m.state, new_cents,
                                 batch)
    errs = aux["shard_errors"].tolist()
    assert errs[0] & mt.ABORT_BITS and errs[1] == 0
    assert int(aux["committed"]) == 0 and int(aux["errors"]) == errs[0]
    for s in range(2):
        assert_planes_equal(before[s], interop.state_to_numpy(st[s]))
    (rep,) = m.maintain([mt.merge(0, 1)], strict=False)
    assert not rep.committed and rep.errors & mt.ABORT_BITS
    d, lab = m.search(vecs, 1, NL)
    assert np.array_equal(lab[:, 0].numpy(), ids)
    with pytest.raises(sivf_torch.MaintenanceAborted):
        m.maintain([mt.merge(0, 1)], strict=True)
    assert m.maintain([mt.recluster(2)])[0].committed


# ---------------------------------------------------------------------------
# Tiered pools, and the serve engine over a mesh
# ---------------------------------------------------------------------------

class TieredOracle:
    """The reference's tiered mesh from its single backend: one tiered
    ``sivf.Index`` a shard, fed every batch with the ids it does not own
    set to -1, so each shard's residency decisions are the reference's
    ``_prefetch_shard`` on that shard's own table."""

    def __init__(self, jcfg, cents, n, cb=None):
        self.n = n
        self.js = [sivf.Index(jcfg, cents, min_bucket=B, pq_codebooks=cb)
                   for _ in range(n)]

    def add(self, vecs, ids):
        ids = np.asarray(ids, np.int32)
        for s, j in enumerate(self.js):
            j.add(vecs, np.where(ids % self.n == s, ids, -1))

    def remove(self, ids):
        for j in self.js:
            j.remove(ids)

    def search(self, qs, k, nprobe):
        ds, ls = zip(*(j.search(qs, k, nprobe) for j in self.js))
        d, lab = jtopk_ref(jnp.concatenate(ds, 1), jnp.concatenate(ls, 1),
                           k)
        return np.asarray(d), np.asarray(lab)

    def check(self, t, f) -> None:
        """Port tiered mesh ``t`` (and its all-resident twin ``f``):
        every shard's metadata planes, host store, residency maps and
        frames; the mesh's counters the sums of the shards'."""
        sub = t._tiered.shards
        for s, j in enumerate(self.js):
            meta = interop.state_to_numpy(t.state[s])
            want = jax_planes(j.state)
            full = interop.state_to_numpy(f.state[s])
            for name in PLANES:
                if name in ("data", "codes", "attrs"):
                    assert np.array_equal(getattr(sub[s].store, name),
                                          full[name]), name
                    assert np.array_equal(getattr(j._tiered.stores[0],
                                                  name), full[name]), name
                elif name == "norms":
                    np.testing.assert_allclose(meta[name], want[name],
                                               rtol=1e-6)
                else:
                    assert np.array_equal(meta[name], want[name]), name
            jr, tr = j._tiered.res[0], sub[s].res
            assert np.array_equal(tr.frame_of, jr.frame_of)
            assert np.array_equal(tr.slab_of_frame, jr.slab_of_frame)
            assert np.array_equal(tr.tick, jr.tick) and tr.dirty == jr.dirty
            assert np.array_equal(sub[s].cache.slab_of_frame.numpy(),
                                  np.asarray(j._tiered.cache.slab_of_frame))
        st, per = t.stats(), [j.stats() for j in self.js]
        for key in ("cache_hits", "cache_misses", "cache_uploads",
                    "cache_evictions", "dedup_refs", "dedup_unique_refs",
                    "dedup_saved_fetches", "dirty_slabs", "resident_slabs"):
            assert st[key] == sum(p[key] for p in per), key
        assert st["per_shard_resident"] == [p["resident_slabs"]
                                             for p in per]


@pytest.mark.parametrize("case", ["raw", "pq"])
def test_tiered_mesh_matches_per_shard_reference(rng, case, monkeypatch):
    """A tiered mesh (16 frames a shard, so batches evict) beside an
    all-resident mesh and the reference's tiered index per shard, through
    adds, overwrites, removes and searches: results ``==`` the
    all-resident mesh bit for bit and the reference's merged ones; every
    shard's planes, store, residency and frames as the reference's."""
    jcfg, tcfg = cfgs(PQ_CASES[case], device_slabs=16)
    _, fcfg = cfgs(PQ_CASES[case])
    if tcfg.pq is not None:
        share_adc(monkeypatch)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = codebooks(rng, tcfg)
    oracle = TieredOracle(jcfg, cents, 3, cb)
    t = sivf_torch.Index(tcfg, cents, backend=mesh(3), min_bucket=B,
                         pq_codebooks=cb)
    f = sivf_torch.Index(fcfg, cents, backend=mesh(3), min_bucket=B,
                         pq_codebooks=cb)
    vecs = rng.normal(size=(256, D)).astype(np.float32)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    for lo in range(0, 256, B):
        ids = np.arange(lo, lo + B)
        for x in (t, f):
            x.add(vecs[ids], ids)
        oracle.add(vecs[ids], ids)
        res = t.search(qs, 5, 4)
        assert torch.equal(res.labels, f.search(qs, 5, 4).labels)
        assert torch.equal(res.distances, f.search(qs, 5, 4).distances)
        assert_search(res, oracle.search(qs, 5, 4), tcfg.pq is not None)
        oracle.check(t, f)
    over, gone = np.arange(0, 60, 3), np.arange(1, 256, 5)
    for x in (t, f):
        x.add(vecs[over] + 0.5, over)
        x.remove(gone)
    oracle.add(vecs[over] + 0.5, over)
    oracle.remove(gone)
    ticket = t.prefetch(qs, nprobe=NL)          # a full probe, staged
    assert t.stats()["dirty_slabs"] == 0
    got = t.search(qs, 5, NL, _prefetched=ticket)
    assert torch.equal(got.labels, f.search(qs, 5, NL).labels)
    assert_search(got, oracle.search(qs, 5, NL), tcfg.pq is not None)
    oracle.check(t, f)


def test_tiered_mesh_lifecycle(rng, tmp_path):
    """Save, load, reshard (counters carried) and maintenance of a
    tiered mesh, each ``==`` the all-resident mesh / single index."""
    _, tcfg = cfgs()
    tiered = dataclasses.replace(tcfg, device_slabs=20)
    t, _ = churned(rng, tiered, mesh(2), n=160)
    f, _ = churned(np.random.default_rng(0), tcfg, mesh(2), n=160)
    qs = rng.normal(size=(4, D)).astype(np.float32)
    t2, _ = churned(np.random.default_rng(0), tiered, mesh(2), n=160)
    want = results(f, qs)
    assert np.array_equal(results(t2, qs)[1], want[1])
    t2.save(tmp_path / "t")
    f.save(tmp_path / "f")
    from repro_torch.checkpoint.manager import CheckpointManager
    got_t, got_f = (CheckpointManager(tmp_path / x).restore_arrays(0)
                    for x in ("t", "f"))
    for name, a, b in zip(PLANES, got_t, got_f):   # the same arrays saved
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    loaded = sivf_torch.Index.load(tmp_path / "f", backend=mesh(2),
                                   device_slabs=20)
    assert loaded._tiered is not None
    got = results(loaded, qs)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
    hits = t2.stats()["cache_hits"]
    for tgt in (mesh(3), "single", mesh(2)):
        t2.reshard(tgt)
        assert t2._tiered is not None and t2.stats()["cache_hits"] >= hits
        hits = t2.stats()["cache_hits"]
        got = results(t2, qs)
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1]), tgt
    for op in (mt.split(0, 1), mt.recluster(2)):
        (rt,), (rf,) = t2.maintain([op]), f.maintain([op])
        assert dataclasses.astuple(rt) == dataclasses.astuple(rf)
        assert_tables_equal(dist.flatten_live_rows(
            tcfg, interop_full(t2)), dist.flatten_live_rows(tcfg, f.state))
        assert np.array_equal(results(t2, qs)[1], results(f, qs)[1])
    n_live = t2.n_live
    t2.reshard("single")
    assert t2.n_live == n_live and t2.backend == "single"


def interop_full(index):
    """A tiered mesh handle's full pools, stacked (what it saves)."""
    from repro_torch.core import tiered as trt
    index._tiered.drain_plans()
    return trt.assemble_full_mesh(index.cfg, index.state,
                                  index._tiered.stores)


def test_serve_engine_over_a_mesh_index(rng):
    """Searches queued while paused are coalesced into tiles; each result
    ``==`` its rows of a direct search of the same handle."""
    _, tcfg = cfgs(attributes=("tenant",))
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    idx = sivf_torch.Index(tcfg, cents, backend=mesh(3), min_bucket=16,
                           deferred=True)
    eng = sivf_torch.ServeEngine(idx, default_k=5, max_coalesce=8,
                                 default_nprobe=4)
    try:
        ids = np.arange(150, dtype=np.int32)
        vecs = rng.normal(size=(150, D)).astype(np.float32)
        r = eng.session("ingest").add(vecs, ids,
                                      attrs={"tenant": ids % 3}).result(30)
        assert r.report.accepted == 150 and r.report.shard_errors == \
            (sivf_torch.ErrorCode.NONE,) * 3
        eng.pause()
        qs = [rng.normal(size=(int(rng.integers(1, 4)), D)).astype(
            np.float32) for _ in range(6)]
        futs = [eng.session("app").search(q, k=5, nprobe=4) for q in qs]
        eng.resume()
        got = [f.result(30) for f in futs]
    finally:
        eng.close()
    assert max(g.coalesced for g in got) > 1
    for q, g in zip(qs, got):
        d, lab = idx.search(q, 5, 4)
        assert np.array_equal(g.labels, lab.numpy())
        assert np.array_equal(g.distances, d.numpy())
