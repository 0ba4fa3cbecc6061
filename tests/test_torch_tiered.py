"""The port's tiered slab pool against the reference's, on the CPU.

The reference's tiered ``sivf.Index`` and the port's
(``sivf_torch.Index(device="cpu")``, ``SIVFConfig(device_slabs=)``) run
the same op sequence (``tests/parity.py``'s twin churn: bulk add,
overwrite, delete, a refill that recycles reclaimed slabs), raw at two
cache sizes, PQ, filtered, and with rejected rows. After every search:

  * labels ``==``, raw distances allclose(1e-5) against the reference
    (``tests/parity.py``), and ``==`` against the port's all-resident
    index, PQ included;
  * the residency maps ``==`` (the host twins and the device
    ``frame_of`` / ``slab_of_frame``) and every cache counter ``==``
    (hits, misses, uploads, evictions, dedupe, dirty slabs).

Besides: the commit plan ``==`` the reference's; the cache too small,
the ``device_slabs`` validation, the dedupe of shared slabs and
``memory_report`` as the reference has them; a warm search makes no
host-to-device copy; prefetch tickets; windowed and cumulative hit
rates; and kernels 1 and 2 (their plain versions here) giving ``==``
results on a frame-translated table, with their launch plans taking the
frame view (meta tensors).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity
import sivf
import sivf_torch
from repro.core import index as jix
from repro.core import state as jstate
from repro_torch import interop
from repro_torch.core import index as tix
from repro_torch.core import state as tst
from repro_torch.core import tiered as trt
from repro_torch.kernels.sivf_scan import fused, ops, pq_fused

from test_torch_pq import tpred_of

D, NL = 16, 8


def cfgs(device_slabs=None, **kw):
    """The reference's and the port's config (``tests/test_tiered.py``'s
    shapes)."""
    base = {**dict(dim=D, n_lists=NL, n_slabs=64, capacity=32, n_max=4096,
                   device_slabs=device_slabs), **kw}
    pq = base.pop("pq", None)
    return (sivf.SIVFConfig(pq=None if pq is None else sivf.PQConfig(*pq),
                            **base),
            sivf_torch.SIVFConfig(
                pq=None if pq is None else sivf_torch.PQConfig(*pq), **base))


class Trio:
    """The reference's tiered index, the port's tiered index and the
    port's all-resident twin, on one set of centroids (and codebooks)."""

    def __init__(self, rng, device_slabs, **kw):
        jcfg, tcfg = cfgs(device_slabs, **kw)
        _, fcfg = cfgs(None, **kw)
        cents = rng.normal(size=(NL, D)).astype(np.float32)
        cb = None
        if tcfg.pq is not None:
            cb = rng.normal(size=tcfg.codebook_shape).astype(np.float32)
        self.j = sivf.Index(jcfg, jnp.asarray(cents), pq_codebooks=cb)
        self.t = sivf_torch.Index(tcfg, cents, device="cpu", pq_codebooks=cb)
        self.f = sivf_torch.Index(fcfg, cents, device="cpu", pq_codebooks=cb)

    @property
    def all(self):
        return (self.j, self.t, self.f)

    def churn(self, rng, attrs=False):
        vecs = rng.normal(size=(600, D)).astype(np.float32)
        ids = np.arange(600, dtype=np.int32)
        fn = (lambda n: {"tenant": np.arange(n) % 3}) if attrs else None
        parity.twin_churn(rng, self.all, vecs, ids,
                          attrs={"tenant": ids % 3} if attrs else None,
                          attrs_fn=fn)

    def search(self, qs, k, nprobe, pred=None):
        dj, lj = self.j.search(qs, k, nprobe, filter=pred)
        tp = None if pred is None else tpred_of(pred)
        rt = self.t.search(qs, k, nprobe, filter=tp)
        rf = self.f.search(qs, k, nprobe, filter=tp)
        assert np.array_equal(rt.labels.numpy(), np.asarray(lj))
        np.testing.assert_allclose(rt.distances.numpy(), np.asarray(dj),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(rt.labels, rf.labels)
        assert torch.equal(rt.distances, rf.distances)     # bit for bit
        self.check_residency()
        return rt

    def check_residency(self):
        jr, tr = self.j._tiered, self.t._tiered
        assert np.array_equal(tr.res.frame_of, jr.res[0].frame_of)
        assert np.array_equal(tr.res.slab_of_frame, jr.res[0].slab_of_frame)
        assert np.array_equal(tr.res.tick, jr.res[0].tick)
        assert tr.res.dirty == jr.res[0].dirty
        assert np.array_equal(tr.cache.frame_of.numpy(),
                              np.asarray(jr.cache.frame_of))
        assert np.array_equal(tr.cache.slab_of_frame.numpy(),
                              np.asarray(jr.cache.slab_of_frame))
        sj, st = self.j.stats(), self.t.stats()
        for key in ("cache_hits", "cache_misses", "cache_uploads",
                    "cache_evictions", "dedup_refs", "dedup_unique_refs",
                    "dedup_saved_fetches", "dirty_slabs", "resident_slabs",
                    "hit_rate", "hit_rate_window", "per_shard_resident",
                    "host_bytes", "device_bytes", "device_cache_bytes",
                    "n_live", "list_occupancy"):
            assert st[key] == sj[key], key
        assert tr.last_prefetch == jr.last_prefetch
        # the frames hold the host store's rows of their slabs
        sof = tr.res.slab_of_frame
        on = np.flatnonzero(sof >= 0)
        for name in trt.PAYLOAD_PLANES:
            got = getattr(tr.cache, name).numpy()[on]
            want = getattr(tr.store, name)[sof[on]]
            fresh = [i for i, s in enumerate(sof[on])
                     if int(s) not in tr.res.dirty]
            assert np.array_equal(got[fresh], want[fresh]), name


@pytest.mark.parametrize("device_slabs", [20, 40])
def test_raw_matches_reference_under_churn(rng, device_slabs):
    """At 20 frames one-query batches' probed sets churn the LRU
    (evictions); at 40 the whole pool fits and a full probe runs cold,
    then warm."""
    tr = Trio(rng, device_slabs)
    tr.churn(rng)
    if device_slabs < 30:
        for nprobe in (2, 1, 3) * 5:
            tr.search(rng.normal(size=(1, D)).astype(np.float32), 10,
                      nprobe)
    else:
        qs = rng.normal(size=(5, D)).astype(np.float32)
        for nprobe in (2, 4, NL, NL):
            tr.search(qs, 10, nprobe)
    assert (tr.t.stats()["cache_evictions"] > 0) == (device_slabs < 30)
    # the host store holds the all-resident pool's payloads
    st = tr.t._tiered.store
    assert np.array_equal(st.data, tr.f.state.data.numpy())


def test_pq_matches_reference(rng):
    tr = Trio(rng, 32, pq=(4, 4))
    tr.churn(rng)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    for nprobe in (4, 4):
        tr.search(qs, 10, nprobe)
    assert np.array_equal(tr.t._tiered.store.codes,
                          tr.f.state.codes.numpy())
    assert tr.t.state.codes.shape[0] == 0


def test_filtered_matches_reference(rng):
    tr = Trio(rng, 40, attributes=("tenant",))
    tr.churn(rng, attrs=True)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    for pred in (sivf.Eq("tenant", 1), sivf.In("tenant", (0, 2))):
        tr.search(qs, 10, NL, pred)


def test_rejected_rows_stay_out_of_the_store(rng):
    """Rows the commit rejects (out-of-range ids, superseded duplicates)
    write nothing to the host store: their plan rows are -1."""
    tr = Trio(rng, 40)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    bad = np.arange(600, dtype=np.int32)
    bad[::7] = 100_000                     # outside [0, n_max)
    bad[1::11] = 3                         # duplicates of id 3
    for idx in tr.all:
        assert idx.add(vecs, bad).rejected > 0
    tr.search(rng.normal(size=(4, D)).astype(np.float32), 10, NL)
    assert np.array_equal(tr.t._tiered.store.data, tr.f.state.data.numpy())


def _plan_inputs(rng, jcfg, tcfg, n):
    vecs = rng.normal(size=(64, D)).astype(np.float32)
    ids = np.full(64, -1, np.int32)
    ids[:n] = rng.integers(-3, 4200, n)                # dupes, bad ids
    ids[: n // 4] = rng.integers(0, 20, n // 4)
    lists = rng.integers(0, NL, 64).astype(np.int32)
    return vecs, ids, lists


@pytest.mark.parametrize("pq", [None, (4, 4)], ids=["raw", "pq"])
def test_commit_plan_matches_reference(rng, pq):
    """``_insert_impl(want_plan=True)``: the (slab, slot) of each input
    row and its codes ``==`` the reference's wherever it wrote, -1 where
    it did not (padding, bad ids, superseded duplicates, and every row of
    an aborted batch); the device payload planes stay zero-width."""
    jcfg, tcfg = cfgs(8, n_slabs=12, max_chain=8,
                      **({} if pq is None else {"pq": pq}))
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = None if pq is None else rng.normal(
        size=tcfg.codebook_shape).astype(np.float32)
    js = jstate.init_state(jcfg, jnp.asarray(cents),
                           None if cb is None else jnp.asarray(cb))
    ts = tst.init_state(tcfg, cents, cb, device="cpu")
    jins = jax.jit(lambda s, v, i, l: jix._insert_impl(
        jcfg, s, v, i, l, want_plan=True))
    aborted = False
    for n in (40,) + (64,) * 8:
        vecs, ids, lists = _plan_inputs(rng, jcfg, tcfg, n)
        js, jp = jins(jstate.clear_error(js), jnp.asarray(vecs),
                      jnp.asarray(ids), jnp.asarray(lists))
        ts, tp = tix._insert_impl(tcfg, tst.clear_error(ts),
                                  torch.from_numpy(vecs),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(lists), want_plan=True)
        slab = np.asarray(jp["slab"])
        assert np.array_equal(tp["slab"].numpy(), slab)
        w = slab >= 0
        assert np.array_equal(tp["slot"].numpy()[w],
                              np.asarray(jp["slot"])[w])
        assert np.array_equal(tp["codes"].numpy()[w],
                              np.asarray(jp["codes"])[w])
        assert tp["codes"].shape == (64, tcfg.code_m)
        assert int(ts.error) == int(js.error)
        if int(ts.error) & tst.ERR_POOL_EXHAUSTED:
            aborted = True
            assert (tp["slab"] == -1).all()
        assert ts.data.shape[0] == ts.codes.shape[0] == 0
    assert aborted                        # the pool ran out on the way


def test_cache_too_small_raises(rng):
    tr = Trio(rng, 4)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    for idx in (tr.j, tr.t):
        idx.add(vecs, np.arange(600, dtype=np.int32))
    qs = rng.normal(size=(8, D)).astype(np.float32)
    with pytest.raises(ValueError, match="device_slabs") as ej:
        tr.j.search(qs, k=5, nprobe=NL)
    with pytest.raises(ValueError, match="device_slabs") as et:
        tr.t.search(qs, k=5, nprobe=NL)
    assert str(et.value) == str(ej.value)


def test_device_slabs_validation():
    for bad in (0, 65):
        with pytest.raises(ValueError, match="device_slabs"):
            cfgs(bad)
    for good in (1, 64):
        _, tcfg = cfgs(good)
        assert tcfg.tiered and tcfg.payload_slabs == 0
    _, flat = cfgs(None)
    assert not flat.tiered and flat.payload_slabs == 64


def test_prefetch_dedupes_shared_slabs(rng):
    """Slabs shared by several probed lists and queries upload once; a
    warm repeat uploads nothing; the counts are the reference's."""
    tr = Trio(rng, 64)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    for idx in tr.all:
        idx.add(vecs, np.arange(600, dtype=np.int32))
    qs = rng.normal(size=(16, D)).astype(np.float32)
    tr.search(qs, 5, NL)
    last = tr.t._tiered.last_prefetch
    assert last["refs"] > last["unique"] == last["uploaded"]
    assert last["dedup_saved"] == last["refs"] - last["unique"]
    tr.search(qs, 5, NL)
    assert tr.t._tiered.last_prefetch["uploaded"] == 0
    assert tr.t._tiered.last_prefetch["hits"] == last["unique"]


@pytest.mark.parametrize("kw", [
    {}, {"device_slabs": 16}, {"device_slabs": 64},
    {"device_slabs": 9, "pq": (4, 4), "attributes": ("a", "b")},
    {"device_slabs": 33, "pq": (8, 5), "capacity": 64}],
    ids=["flat", "ds16", "ds64", "pq-attrs", "pq-c64"])
def test_memory_report_matches_reference(kw):
    kw = dict(kw)
    ds = kw.pop("device_slabs", None)
    jcfg, tcfg = cfgs(ds, **kw)
    assert tst.memory_report(tcfg) == jstate.memory_report(jcfg)
    mr = tst.memory_report(tcfg)
    assert mr["total_bytes"] == mr["host_bytes"] + mr["device_bytes"]


def test_warm_search_makes_no_upload(rng, monkeypatch):
    """A cold search uploads its misses in one packed copy; warm repeats
    copy nothing to the device and read the device once each (the
    table's counts); an insert dirties slabs and the next search makes
    one refresh copy."""
    _, tcfg = cfgs(64)
    idx = sivf_torch.Index(tcfg, rng.normal(size=(NL, D)).astype(
        np.float32), device="cpu")
    idx.add(rng.normal(size=(600, D)).astype(np.float32),
            np.arange(600, dtype=np.int32))
    rt = idx._tiered
    calls = []
    real = trt.TieredRuntime._upload
    monkeypatch.setattr(trt.TieredRuntime, "_upload",
                        lambda self, f, s: (calls.append(len(f)),
                                            real(self, f, s))[1])
    qs = torch.from_numpy(rng.normal(size=(64, D)).astype(np.float32))
    cold = idx.search(qs, 10, NL)
    assert len(calls) == 1 and rt.h2d_copies == 1
    assert calls[0] == rt.stats()["cache_uploads"]
    assert rt.h2d_bytes == calls[0] * (8 + rt.slab_bytes)
    reads = rt.d2h_reads
    for i in range(3):
        warm = idx.search(qs, 10, NL)
        assert torch.equal(warm.labels, cold.labels)
        assert torch.equal(warm.distances, cold.distances)
    assert len(calls) == 1 and rt.h2d_copies == 1
    assert rt.d2h_reads == reads + 3
    idx.add(rng.normal(size=(64, D)).astype(np.float32),
            np.arange(3000, 3064, dtype=np.int32))
    assert rt.stats()["pending_plans"] == 1
    idx.search(qs, 10, NL)
    assert len(calls) == 2 and rt.h2d_copies == 2
    assert rt.stats()["pending_plans"] == 0 and rt.stats()["dirty_slabs"] == 0


def test_prefetch_ticket_skips_stages(rng):
    _, tcfg = cfgs(64)
    _, fcfg = cfgs(None)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    it = sivf_torch.Index(tcfg, cents, device="cpu")
    flat = sivf_torch.Index(fcfg, cents, device="cpu")
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    for idx in (it, flat):
        idx.add(vecs, np.arange(600, dtype=np.int32))
    qs = rng.normal(size=(6, D)).astype(np.float32)
    t = it.prefetch(qs, nprobe=4)
    assert t is not None and t.seq == it._tiered.seq
    seq, reads = it._tiered.seq, it._tiered.d2h_reads
    res = it.search(qs, k=10, nprobe=4, _prefetched=t)
    assert it._tiered.seq == seq and it._tiered.d2h_reads == reads
    parity.assert_results_same(res, flat.search(qs, k=10, nprobe=4))
    # a mutation makes the ticket stale (epoch moved): the full path runs
    t2 = it.prefetch(qs, nprobe=4)
    for idx in (it, flat):
        idx.add(vecs[:8] + 1, np.arange(4000, 4008, dtype=np.int32))
    res2 = it.search(qs, k=10, nprobe=4, _prefetched=t2)
    assert it._tiered.seq == t2.seq + 1
    parity.assert_results_same(res2, flat.search(qs, k=10, nprobe=4))
    # another prefetch makes it stale too; a different nprobe as well
    t3 = it.prefetch(qs, nprobe=4)
    it.prefetch(qs[:2], nprobe=2)
    parity.assert_results_same(it.search(qs, 10, 4, _prefetched=t3),
                               flat.search(qs, 10, 4))
    t4 = it.prefetch(qs, nprobe=4)
    parity.assert_results_same(it.search(qs, 10, NL, _prefetched=t4),
                               flat.search(qs, 10, NL))
    assert flat.prefetch(qs) is None


def test_hit_rate_windowed_and_cumulative(rng):
    tr = Trio(rng, 32)
    vecs = rng.normal(size=(600, D)).astype(np.float32)
    for idx in tr.all:
        idx.add(vecs, np.arange(600, dtype=np.int32))
    qs = rng.normal(size=(5, D)).astype(np.float32)
    tr.search(qs, 10, NL)                     # cold: misses + uploads
    st = tr.t.stats()
    assert st["hit_rate_kind"] == "cumulative"
    assert 0.0 <= st["hit_rate"] < 1.0
    assert st["hit_rate_window"] == st["hit_rate"]
    for idx in (tr.j, tr.t):
        idx._tiered.roll_window()
    st = tr.t.stats()
    assert st["cache_misses_window"] == 0 and st["cache_misses"] > 0
    tr.search(qs, 10, NL)                     # warm: same probe set
    st = tr.t.stats()
    assert st["hit_rate_window"] == 1.0 and st["hit_rate"] < 1.0
    # a rebuilt runtime carries the cumulative counters and their marks
    fresh = trt.TieredRuntime(tr.t.cfg, "cpu").carry_from(tr.t._tiered)
    for key in ("cache_hits", "cache_misses", "cache_uploads",
                "hit_rate", "hit_rate_window"):
        assert fresh.stats()[key] == st[key], key


# ---------------------------------------------------------------------------
# Kernels 1 and 2 on the frame view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pq", [None, (4, 4)], ids=["kernel1", "kernel2"])
def test_translation_leaves_kernel_results_unchanged(rng, pq):
    """On one state, the scan of the pool-slab table over the full planes
    and of the translated table over the frame view agree ``==`` (plain
    versions: what the CUDA kernels equal bit for bit), filtered too; and
    the launch plans take the frame view: kernel 1's grouped scratch is
    sized by the frame count, kernel 2 stays on ``compacted``."""
    kw = {"attributes": ("tenant",)}
    if pq is not None:
        kw["pq"] = pq
    _, fcfg = cfgs(None, **kw)
    _, tcfg = cfgs(48, **kw)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = None if pq is None else rng.normal(
        size=fcfg.codebook_shape).astype(np.float32)
    flat = sivf_torch.Index(fcfg, cents, device="cpu", pq_codebooks=cb)
    it = sivf_torch.Index(tcfg, cents, device="cpu", pq_codebooks=cb)
    vecs = rng.normal(size=(900, D)).astype(np.float32)
    for idx in (flat, it):
        idx.add(vecs, np.arange(900), attrs={"tenant": np.arange(900) % 4})
        idx.remove(np.arange(0, 900, 5))
    qs = torch.from_numpy(rng.normal(size=(7, D)).astype(np.float32))
    rt = it._tiered
    table = rt.plan(it.state, qs, 5)
    rt.prefetch(table, 5, it.epoch)
    ftable = ops.translate_table(table, rt.cache.frame_of)
    assert ftable.dtype == torch.int32 and torch.equal(ftable < 0, table < 0)
    view = trt.cache_view(tcfg, it.state, rt.cache)
    cf = sivf_torch.compile_filter(sivf_torch.In("tenant", (1, 3)),
                                   ("tenant",))
    fc = torch.tensor(cf.consts, dtype=torch.int32)
    for filt in ({}, {"fstruct": cf.structure, "fconsts": fc}):
        want = tix._scan_dispatch(fcfg, flat.state, qs, table, 10, **filt)
        got = tix._scan_dispatch(tcfg, view, qs, ftable, 10, **filt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    if pq is None:
        p = fused.launch_plan(meta(qs), meta(ftable), meta(view.data), 10)
        assert p["route"] == "grouped"
        assert p["scratch_bytes"] == fused.grouped_scratch_bytes(
            qs.shape[0], ftable.shape[1], tcfg.device_slabs, 10)
        assert view.data.shape[0] == tcfg.device_slabs
    else:
        adc = torch.empty((7, pq[0], 1 << pq[1]), device="meta")
        p = pq_fused.launch_plan(adc, meta(ftable), meta(view.codes), 10)
        assert p["route"] == "compacted"
        assert view.codes.shape[0] == tcfg.device_slabs


def test_full_state_split_and_assemble(rng):
    """``split_full`` / ``assemble_full`` round-trip a full pool; a tiered
    handle built from a full state searches like the all-resident one."""
    _, fcfg = cfgs(None, attributes=("tenant",))
    tcfg = dataclasses.replace(fcfg, device_slabs=20)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    flat = sivf_torch.Index(fcfg, cents, device="cpu")
    flat.add(rng.normal(size=(300, D)).astype(np.float32), np.arange(300),
             attrs={"tenant": np.arange(300) % 2})
    full = interop.state_to_numpy(flat.state)
    assert trt.is_full_state(fcfg, full) and trt.is_full_state(tcfg, full)
    meta, store = trt.split_full(tcfg, full)
    assert not trt.is_full_state(tcfg, meta)
    back = trt.assemble_full(tcfg, interop.state_from_numpy(
        tcfg, meta, device="cpu"), store)
    for name in tst.PLANES:
        assert np.array_equal(back[name], full[name]), name
    it = sivf_torch.Index(tcfg, None, device="cpu", _state=flat.state)
    qs = rng.normal(size=(3, D)).astype(np.float32)
    parity.assert_results_same(it.search(qs, 5, 2), flat.search(qs, 5, 2))
