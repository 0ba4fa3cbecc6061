"""The port's streaming serve engine against the reference's, on the CPU.

``sivf_torch.ServeEngine`` over ``sivf_torch.Index(device="cpu")`` and the
reference's ``sivf.ServeEngine`` over its ``sivf.Index`` start from one
slab-pool state (the reference's, carried across with
``repro_torch.interop.state_from_numpy``) and get the same request
batches, queued while both engines are paused so that both coalesce them
into the same tiles. Per request: labels ``==``, raw distances
``allclose(1e-5)`` and PQ distances ``==`` (the contract of
``tests/parity.py``: for PQ one materialized ADC table feeds both, so
the port's search takes the reference's table for its queries, as
``tests/test_torch_pq.py`` does), and equal epochs, ``coalesced`` counts and
``padded_to`` buckets; the mutation reports are equal; after ``close()``
every integer plane of the two states is equal. Raw and PQ, with and
without a tenant's mandatory filter.

Besides, on the port alone: the token bucket and the in-flight cap give
the reference's accept / reject sequence under one injected clock; the
cases of ``tests/test_serve_engine.py`` (the construction contract, the
typed rejections, the threaded epoch-prefix oracle, drain,
``close(drain=False)``, queue waits under ``pause``, tile provenance, the
bounded launch signatures); and a tiered engine whose frames cannot hold
two tiles' slabs, so that each tile evicts the last one's, ``==`` an
all-resident engine on every request.
"""
import dataclasses
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro.serve import quota as jquota
from repro_torch.core.state import PLANES
from repro_torch.obs import Telemetry
from repro_torch.serve import quota as tquota
from sivf_torch import Backpressure, BackpressureKind, ServeEngine, TenantQuota

DIM, NL = 16, 8


# ---------------------------------------------------------------------------
# quota: the reference's admissions under one injected clock
# ---------------------------------------------------------------------------

def admissions(mod, seed: int) -> tuple[list, dict]:
    """A seeded sequence of search admissions, releases and mutation
    admissions on one tenant -> (outcome of each, rejections by kind)."""
    rng = np.random.default_rng(seed)
    now = [0.0]
    st = mod.TenantState(mod.TenantQuota(max_inflight_searches=3,
                                         mutation_rows_per_s=200.0,
                                         mutation_burst_rows=64),
                         clock=lambda: now[0])
    out = []
    for _ in range(300):
        now[0] += float(rng.uniform(0, 0.05))
        op = int(rng.integers(0, 3))
        try:
            if op == 0:
                st.admit_search("a")
            elif op == 1:
                st.release_search()
            else:
                st.admit_mutation("a", int(rng.integers(1, 40)))
            out.append("ok")
        except mod.Backpressure as e:
            out.append((e.kind.value, e.tenant, str(e)))
    return out, {k.value: n for k, n in st.rejections.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quota_admissions_equal_the_reference(seed):
    got, rej = admissions(tquota, seed)
    want, jrej = admissions(jquota, seed)
    assert got == want and rej == jrej
    assert {o[0] for o in got if o != "ok"} == {"search_inflight",
                                                "mutation_rate"}
    assert [k.value for k in tquota.BackpressureKind] == \
        [k.value for k in jquota.BackpressureKind]
    assert dataclasses.asdict(tquota.TenantQuota()) == \
        dataclasses.asdict(jquota.TenantQuota())


# ---------------------------------------------------------------------------
# engine parity: the reference's engine and the port's on one state
# ---------------------------------------------------------------------------

CASES = {"raw": {}, "raw_tenant": {"attributes": ("tenant",)},
         "pq_tenant": {"attributes": ("tenant",), "pq": (4, 8)}}


def cfgs(**kw):
    """The reference's and the port's config (shared by every parity case
    of one kind, so the reference compiles each shape once)."""
    base = dict(dim=DIM, n_lists=NL, n_slabs=192, capacity=32, n_max=8192)
    base.update(kw)
    pq = base.pop("pq", None)
    return (sivf.SIVFConfig(pq=None if pq is None else sivf.PQConfig(*pq),
                            **base),
            sivf_torch.SIVFConfig(
                pq=None if pq is None else sivf_torch.PQConfig(*pq), **base))


def planes_of(index) -> dict:
    return {name: np.array(getattr(index.state, name)) for name in PLANES}


def twin_engines(rng, case: str, **eng_kw):
    """(reference engine, port engine) over one state: the reference's
    empty index (centroids and PQ codebooks) carried to the port."""
    jcfg, tcfg = cfgs(**CASES[case])
    cents = rng.normal(size=(NL, DIM)).astype(np.float32)
    cb = None
    if tcfg.pq is not None:
        cb = rng.normal(size=tcfg.codebook_shape).astype(np.float32)
    j = sivf.Index(jcfg, jnp.asarray(cents), deferred=True, min_bucket=16,
                   pq_codebooks=cb)
    t = sivf_torch.Index(tcfg, None, device="cpu", deferred=True,
                         min_bucket=16, _state=planes_of(j),
                         _pq_trained=True)
    filt = {}
    if tcfg.n_attrs:
        filt = {"t1": (sivf.Eq("tenant", 1), sivf_torch.Eq("tenant", 1))}
    je = sivf.ServeEngine(j, tenant_filters={k: v[0]
                                             for k, v in filt.items()},
                          **eng_kw)
    te = ServeEngine(t, tenant_filters={k: v[1] for k, v in filt.items()},
                     **eng_kw)
    return je, te


def cycle(eng, reqs: list) -> list:
    """Queue ``reqs`` while paused, resume, wait for every future."""
    eng.pause()
    futs = []
    for tenant, op, a, kw in reqs:
        sess = eng.session(tenant)
        if op == "search":
            futs.append(sess.search(a, **kw))
        elif op == "add":
            futs.append(sess.add(*a, **kw))
        else:
            futs.append(sess.remove(a))
    eng.resume()
    return [f.result(30) for f in futs]


def report_tuple(rep) -> tuple:
    return (rep.op, rep.requested, rep.accepted, rep.overwritten,
            rep.rejected, int(rep.errors), rep.n_live, rep.padded_to)


def traffic(rng, attrs: bool, n_cycles: int = 4) -> list:
    """Request batches: an ingest cycle, then cycles of coalescible
    searches from two tenants (k 5 and 3, Q 1-3) mixed with an add and a
    remove (the searches dispatch first, at the cycle's epoch)."""
    out = []
    nxt = 0
    for c in range(n_cycles):
        reqs = []
        if c == 0:
            for _ in range(4):
                ids = np.arange(nxt, nxt + 16, dtype=np.int32)
                nxt += 16
                kw = {"attrs": {"tenant": ids % 3}} if attrs else {}
                reqs.append(("ingest", "add", (
                    rng.normal(size=(16, DIM)).astype(np.float32), ids), kw))
        else:
            tenants = ("app", "t1") if attrs else ("app", "app2")
            for i in range(9):
                q = rng.normal(size=(int(rng.integers(1, 4)), DIM)).astype(
                    np.float32)
                kw = {"k": (5, 3)[i % 2], "nprobe": 4}
                reqs.append((tenants[i % 2], "search", q, kw))
            ids = np.arange(nxt, nxt + 12, dtype=np.int32)
            nxt += 12
            kw = {"attrs": {"tenant": ids % 3}} if attrs else {}
            reqs.append(("ingest", "add", (
                rng.normal(size=(12, DIM)).astype(np.float32), ids), kw))
            reqs.append(("ingest", "remove",
                         rng.choice(nxt, 6, replace=False).astype(np.int32),
                         {}))
        out.append(reqs)
    return out


def shared_adc(monkeypatch):
    """The port's PQ searches take the reference's ADC table of their
    queries (one materialized table feeds both scans)."""
    import jax

    from repro.core import pq as jpq
    from repro_torch.core import pq as tpq
    jadc = jax.jit(jpq.adc_tables, static_argnames=("metric",))

    def adc_tables(codebooks, queries, metric):
        return torch.from_numpy(np.array(jadc(
            jnp.asarray(codebooks.numpy()), jnp.asarray(queries.numpy()),
            metric)))

    monkeypatch.setattr(tpq, "adc_tables", adc_tables)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_equals_the_reference(rng, case, monkeypatch):
    je, te = twin_engines(rng, case, default_k=5, max_coalesce=8)
    pq = "pq" in case
    if pq:
        shared_adc(monkeypatch)
    n_search = n_mut = 0
    try:
        for reqs in traffic(rng, "tenant" in case):
            got, want = cycle(te, reqs), cycle(je, reqs)
            for (tenant, op, _, _), g, w in zip(reqs, got, want):
                if op != "search":
                    assert g.epoch == w.epoch
                    assert report_tuple(g.report) == report_tuple(w.report)
                    n_mut += 1
                    continue
                assert isinstance(g.labels, np.ndarray)
                assert np.array_equal(g.labels, np.asarray(w.labels))
                if pq:
                    assert np.array_equal(g.distances,
                                          np.asarray(w.distances))
                else:
                    np.testing.assert_allclose(
                        g.distances, np.asarray(w.distances),
                        rtol=1e-5, atol=1e-5)
                assert (g.k, g.nprobe, g.epoch, g.coalesced, g.padded_to) \
                    == (w.k, w.nprobe, w.epoch, w.coalesced, w.padded_to)
                n_search += 1
        ts, js = te.stats(), je.stats()
        for key in ("epoch", "searches", "search_tiles", "coalesce_mean",
                    "coalesce_max", "mutations", "kn_groups"):
            assert ts[key] == js[key], key
    finally:
        te.close()
        je.close()
    assert n_search == 27 and n_mut == 10
    a, b = planes_of(te.index), planes_of(je.index)
    for name in PLANES:
        if a[name].dtype.kind in "iu":
            assert np.array_equal(a[name], b[name].view(a[name].dtype)), name


# ---------------------------------------------------------------------------
# behaviour of the port's engine (tests/test_serve_engine.py's cases)
# ---------------------------------------------------------------------------

def vec_for(i: int) -> np.ndarray:
    return np.random.default_rng(1000 + i).normal(
        size=(DIM,)).astype(np.float32)


def vecs_for(ids) -> np.ndarray:
    return np.stack([vec_for(int(i)) for i in ids])


def engine(rng, *, min_bucket=16, telemetry=None, device_slabs=None,
           n_slabs=256, **eng_kw):
    cfg = sivf_torch.SIVFConfig(dim=DIM, n_lists=NL, n_slabs=n_slabs,
                                capacity=32, n_max=8192,
                                device_slabs=device_slabs)
    cents = rng.normal(size=(NL, DIM)).astype(np.float32)
    idx = sivf_torch.Index(cfg, cents, device="cpu", deferred=True,
                           min_bucket=min_bucket, telemetry=telemetry)
    return idx, ServeEngine(idx, **eng_kw)


def test_engine_requires_deferred_nonstrict_index(rng):
    cfg = sivf_torch.SIVFConfig(dim=DIM, n_lists=4, n_slabs=64, capacity=32,
                                n_max=1024)
    cents = rng.normal(size=(4, DIM)).astype(np.float32)
    with pytest.raises(ValueError, match="deferred=True"):
        ServeEngine(sivf_torch.Index(cfg, cents, device="cpu"))
    with pytest.raises(ValueError, match="strict=False"):
        ServeEngine(sivf_torch.Index(cfg, cents, device="cpu",
                                     deferred=True, strict=True))
    with pytest.raises(TypeError, match="sivf_torch.Index"):
        ServeEngine("not an index")
    with pytest.raises(ValueError, match="max_coalesce"):
        ServeEngine(sivf_torch.Index(cfg, cents, device="cpu",
                                     deferred=True), max_coalesce=0)


def test_roundtrip_validation_and_mutation_errors(rng):
    idx, eng = engine(rng, default_k=5)
    with eng:
        writer, reader = eng.session("ingest"), eng.session("app")
        ids = np.arange(64, dtype=np.int32)
        assert writer.add(vecs_for(ids), ids).result(30).epoch == 1
        eng.pause()
        futs = [reader.search(vec_for(j)[None]) for j in range(8)]
        futs += [reader.search(vec_for(j)[None], k=3, nprobe=2)
                 for j in range(4)]
        eng.resume()
        res = [f.result(30) for f in futs]
        for j, r in enumerate(res[:8]):
            assert r.labels[0, 0] == j and r.distances[0, 0] < 1e-5
            assert r.k == 5 and r.coalesced == 8
        assert {(r.k, r.nprobe) for r in res} == {(5, 8), (3, 2)}
        with pytest.raises(ValueError, match="dim"):
            reader.search(np.zeros((2, DIM + 1), np.float32))
        with pytest.raises(ValueError, match="mismatch"):
            writer.add(np.zeros((2, DIM), np.float32),
                       np.arange(3, dtype=np.int32))
        with pytest.raises(ValueError, match="attrs"):
            writer.add(vecs_for([1]), [1], attrs={"tenant": [0]})
        bad = np.asarray([1, idx.cfg.n_max + 7], np.int32)
        r = writer.add(vecs_for([1, 2]), bad).result(30)
        assert not r.ok and r.report.errors & sivf_torch.ErrorCode.ID_RANGE
        assert r.report.accepted == 0 and r.report.overwritten == 1
        st = eng.stats()
        assert st["searches"] == 12 and st["search_tiles"] == 2
        assert st["prefetch_errors"] == 0 and st["flushes"] == 2
    assert idx.pending_count == 0


@pytest.mark.parametrize("kind", ["search_inflight", "queue_full",
                                  "mutation_rate", "engine_closed"])
def test_typed_rejections(rng, kind):
    now = [0.0]
    idx, eng = engine(
        rng, max_queue=3, clock=lambda: now[0],
        quotas={"capped": TenantQuota(max_inflight_searches=2),
                "bulk": TenantQuota(mutation_rows_per_s=100,
                                    mutation_burst_rows=50)})
    q = vec_for(0)[None]
    if kind == "engine_closed":
        eng.close()
        with pytest.raises(Backpressure) as ei:
            eng.session().search(q)
        assert ei.value.kind is BackpressureKind.ENGINE_CLOSED
        return
    with eng:
        if kind == "search_inflight":
            s = eng.session("capped")
            eng.pause()
            held = [s.search(q), s.search(q)]
            with pytest.raises(Backpressure) as ei:
                s.search(q)
            other = eng.session("other").search(q)   # others unaffected
            assert eng.stats()["queued"] == 3
            eng.resume()
            for f in held + [other]:
                f.result(30)
            s.search(q).result(30)                   # slots released
            assert eng.stats()["rejections"]["capped"] == \
                {"search_inflight": 1}
        elif kind == "queue_full":
            s = eng.session()
            eng.pause()
            ids = np.arange(4, dtype=np.int32)
            futs = [s.add(vecs_for(ids + 4 * i), ids + 4 * i)
                    for i in range(3)]
            with pytest.raises(Backpressure) as ei:
                s.remove(ids)
            assert eng.stats()["queued"] == 3
            eng.resume()
            assert all(f.result(30).ok for f in futs)
        else:
            s = eng.session("bulk")
            ids = np.arange(50, dtype=np.int32)
            f = s.add(vecs_for(ids), ids)             # the whole burst
            with pytest.raises(Backpressure) as ei:
                s.remove(np.arange(1, dtype=np.int32))
            now[0] += 0.5                             # 50 tokens back
            f2 = s.remove(np.arange(40, dtype=np.int32))
            assert f.result(30).ok and f2.result(30).ok
    assert ei.value.kind is BackpressureKind(kind)


def test_search_mid_ingest_observes_committed_prefix(rng):
    """A search stamped epoch e finds a planted id exactly when its batch
    <= e and never returns an id of a later batch."""
    B, n_batches = 32, 12
    idx, eng = engine(rng, default_k=4, flush_every=3)
    with eng:
        writer, reader = eng.session("ingest"), eng.session("app")
        results = []
        stop = threading.Event()

        def searcher():
            r = np.random.default_rng(5)
            while not stop.is_set():
                target = int(r.integers(0, B * n_batches))
                try:
                    fut = reader.search(vec_for(target)[None], nprobe=None)
                except Backpressure:
                    time.sleep(0.005)
                    continue
                results.append((target, fut))
                time.sleep(0.001)

        t = threading.Thread(target=searcher)
        t.start()
        mut_futs = []
        for b in range(n_batches):
            ids = np.arange(b * B, (b + 1) * B, dtype=np.int32)
            mut_futs.append(writer.add(vecs_for(ids), ids))
            time.sleep(0.002)
        # the last batches flush once the engine goes idle: stop the
        # searches (the plain scan keeps the queue busy on the CPU)
        stop.set()
        t.join(30)
        assert not t.is_alive()
        reps = [f.result(30) for f in mut_futs]
        assert all(r.ok for r in reps)
        assert [r.epoch for r in reps] == list(range(1, n_batches + 1))
        seen = {True: 0, False: 0}
        for target, fut in results:
            r = fut.result(30)
            present = bool(r.distances[0, 0] < 1e-5
                           and r.labels[0, 0] == target)
            assert present == (target // B + 1 <= r.epoch), \
                (target, r.epoch)
            seen[present] += 1
            live = r.labels[0][r.labels[0] >= 0]
            assert (live < r.epoch * B).all()
        assert seen[True] > 0
    assert idx.n_live == B * n_batches


@pytest.mark.parametrize("drain", [True, False])
def test_close_drains_or_rejects(rng, drain):
    idx, eng = engine(rng, flush_every=10_000)
    s = eng.session()
    ids = np.arange(200, dtype=np.int32)
    if not drain:
        eng.pause()
    futs = [s.add(vecs_for(ids[i:i + 50]), ids[i:i + 50])
            for i in range(0, 200, 50)]
    futs.append(s.remove(ids[:10]))
    eng.close(drain=drain)
    assert all(f.done for f in futs)
    if drain:
        assert all(f.result(0).ok for f in futs)
        assert idx.n_live == 190
    else:
        with pytest.raises(Backpressure) as ei:
            futs[0].result(5)
        assert ei.value.kind is BackpressureKind.ENGINE_CLOSED
        assert idx.n_live == 0
    assert idx.pending_count == 0
    eng.close()                                   # idempotent


def test_queue_waits_and_tile_provenance_under_pause(rng):
    """Staggered submits held by ``pause`` dispatch in one tile: the
    earliest waited longest, and every member reports the same tile
    provenance and the same service window; the serve.tile span and the
    serve.queue stage agree with it."""
    tel = Telemetry(enabled=True, slow_threshold_s=0.0)
    idx, eng = engine(rng, default_k=5, max_coalesce=128, telemetry=tel)
    with eng:
        writer, reader = eng.session("ingest"), eng.session("app")
        ids = np.arange(32, dtype=np.int32)
        writer.add(vecs_for(ids), ids).result(30)
        eng.pause()
        futs = []
        for j in range(4):
            futs.append(reader.search(vec_for(j)[None]))
            time.sleep(0.02)
        eng.resume()
        res = [f.result(30) for f in futs]
    qs = [r.queue_s for r in res]
    assert all(a > b for a, b in zip(qs, qs[1:])) and qs[0] >= 3 * 0.02
    assert {r.coalesced for r in res} == {4}
    assert {r.padded_to for r in res} == {16}
    assert len({r.epoch for r in res}) == 1
    assert len({r.service_s for r in res}) == 1 and res[0].service_s > 0
    tile = [e for e in tel.slow_queries()
            if e["span"] == "serve.tile" and e.get("rows") == 4][0]
    assert tile["duration_ms"] >= res[0].service_s * 1e3 - 1.0
    assert tile["tenant"] == "app" and tile["epoch"] == res[0].epoch
    assert "index.search" in tile["stages_ms"]
    h = tel.histogram("sivf_stage_seconds", labels=("stage",))
    assert h.get(stage="serve.queue")["count"] == 4
    assert h.get(stage="serve.mutation_queue")["count"] == 1
    assert tel.histogram("sivf_serve_coalesce_rows").get()["count"] == 1


def test_threaded_churn_bounded_launch_signatures(rng):
    idx, eng = engine(rng, default_k=8, min_bucket=8, flush_every=4)
    n_per_client = 20
    errs: list = []
    with eng:
        def searcher(tenant, seed):
            r = np.random.default_rng(seed)
            sess = eng.session(tenant)
            for _ in range(n_per_client):
                q = r.normal(size=(int(r.integers(1, 9)), DIM)
                             ).astype(np.float32)
                try:
                    assert sess.search(q).result(30).labels.shape == \
                        (q.shape[0], 8)
                except Exception as e:
                    errs.append(e)

        def mutator(tenant, seed, base):
            r = np.random.default_rng(seed)
            sess = eng.session(tenant)
            nxt = base
            for i in range(n_per_client):
                n = int(r.integers(1, 33))
                ids = np.arange(nxt, nxt + n, dtype=np.int32)
                nxt += n
                try:
                    assert sess.add(vecs_for(ids), ids).result(30).ok
                    if i % 3 == 2:
                        assert sess.remove(ids[: n // 2]).result(30).ok
                except Exception as e:
                    errs.append(e)

        threads = [threading.Thread(target=searcher, args=("a", 1)),
                   threading.Thread(target=searcher, args=("b", 2)),
                   threading.Thread(target=mutator, args=("ia", 3, 0)),
                   threading.Thread(target=mutator, args=("ib", 4, 4000))]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)        # interleave the threads finely
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:3]
        observed, bound = eng.assert_bounded_compiles()
        assert 0 < observed <= bound
        st = eng.stats()
        assert st["searches"] == 2 * n_per_client and st["queued"] == 0
        assert all(v == 0 for v in st["inflight_searches"].values())
        comp = idx.compile_stats()
        assert comp["add"] <= len(idx.bucket_shapes(32))
        assert comp["remove"] <= len(idx.bucket_shapes(32))
    assert idx.pending_count == 0


def test_bound_catches_a_tile_that_skips_the_padding(rng, monkeypatch):
    """The launch signatures come from the shapes launched: a search that
    does not pad its tile to a bucket mints signatures the bound does not
    allow, and ``assert_bounded_compiles`` fails."""
    idx, eng = engine(rng, default_k=4, min_bucket=4)
    monkeypatch.setattr(idx, "_bucket", lambda n: n)
    with eng:
        for n in (1, 2, 3, 5):
            eng.session().search(
                np.zeros((n, DIM), np.float32)).result(30)
        with pytest.raises(AssertionError, match="exceed"):
            eng.assert_bounded_compiles()


def test_maintenance_requests_bump_the_epoch(rng):
    idx, eng = engine(rng, default_k=4)
    with eng:
        s = eng.session("ops")
        ids = np.arange(400, dtype=np.int32)
        s.add(vecs_for(ids), ids).result(30)
        r = s.maintain([sivf_torch.split(0, 1),
                        sivf_torch.recluster(2)]).result(30)
        assert len(r.reports) == 2 and r.ok
        assert r.epoch == 1 + sum(x.committed and x.rows > 0
                                  for x in r.reports)
        with pytest.raises(TypeError, match="MaintOp"):
            s.maintain(["split"])
        hit = s.search(vec_for(7)[None], nprobe=None).result(30)
        assert hit.labels[0, 0] == 7 and hit.epoch == r.epoch
        assert eng.stats()["maintenance_passes"] == 1


def tile_working_sets(index) -> list[int]:
    """Distinct slabs of a tile whose queries all probe list ``l``, for
    each ``l`` at nprobe 1: a tile pads to its bucket with zero rows, which
    probe the list nearest the origin, so a tiered search of it must hold
    that list's chain beside ``l``'s."""
    from repro_torch.core import index as ix
    from repro_torch.core import quantizer
    st = index.state
    pad = quantizer.probe(st.centroids, torch.zeros((1, DIM)), 1)
    out = []
    for lst in range(NL):
        lists = torch.cat([torch.tensor([[lst]], dtype=torch.int32), pad])
        table = ix.gather_tables(index.cfg, st, lists)
        out.append(int(torch.unique(table[table >= 0]).numel()))
    return out


def test_tiered_engine_evicts_between_tiles_and_equals_all_resident(rng):
    """Tiles of different (k, filter) groups each probe one list (their
    queries sit on its centroid); the frames hold about two lists' slabs,
    so each tile's prefetch evicts frames of the tiles before it, and
    every result is ``==`` the all-resident engine's. Every tile's working
    set (its list's chain and the zero pad rows' list's) fits the 16
    frames before each cycle: the centroids come from a seeded generator,
    not from the process's global one, whose state depends on the tests
    that ran before this one."""
    cfg = dict(dim=DIM, n_lists=NL, n_slabs=96, capacity=32, n_max=8192,
               attributes=("tenant",))
    ids = np.arange(1600, dtype=np.int32)
    vecs = rng.normal(size=(1600, DIM)).astype(np.float32)
    cents = sivf_torch.train_kmeans(
        torch.from_numpy(vecs), NL,
        generator=torch.Generator().manual_seed(0)).numpy()
    seed = sivf_torch.Index(sivf_torch.SIVFConfig(**cfg), cents,
                            device="cpu", min_bucket=8)
    seed.add(vecs, ids, attrs={"tenant": ids % 3})
    full = sivf_torch.Index(sivf_torch.SIVFConfig(**cfg), None,
                            device="cpu", deferred=True, min_bucket=8,
                            _state=planes_of(seed))
    tiered = sivf_torch.Index(
        sivf_torch.SIVFConfig(device_slabs=16, **cfg), None, device="cpu",
        deferred=True, min_bucket=8, _state=planes_of(seed))
    assert seed.stats()["max_chain_len"] <= 12
    engines = [ServeEngine(x, default_nprobe=1, max_coalesce=8,
                           tenant_filters={"t1": sivf_torch.Eq("tenant", 1)})
               for x in (full, tiered)]
    rt = tiered._tiered
    try:
        for c in range(3):
            reqs = []
            for g in range(NL):         # 8 tiles: (k, tenant) groups
                tenant = ("app", "t1")[g % 2]
                for _ in range(2):
                    q = cents[(g + 3 * c) % NL] + 0.01 * rng.normal(
                        size=DIM).astype(np.float32)
                    reqs.append((tenant, "search", q[None],
                                 {"k": 3 + g // 2}))
            if c == 1:                  # an overwrite and a remove
                reqs.append(("ingest", "add", (vecs[:64] + 0.5, ids[:64]),
                             {"attrs": {"tenant": ids[:64] % 3}}))
                reqs.append(("ingest", "remove", ids[500:560], {}))
            assert max(tile_working_sets(tiered)) <= 16
            ev0 = rt.evictions.total
            a, b = (cycle(e, reqs) for e in engines)
            for (_, op, _, _), x, y in zip(reqs, a, b):
                if op == "search":
                    assert np.array_equal(x.labels, y.labels)
                    assert np.array_equal(x.distances, y.distances)
                    assert (x.epoch, x.coalesced) == (y.epoch, y.coalesced)
                else:
                    assert report_tuple(x.report) == report_tuple(y.report)
            assert rt.evictions.total > ev0
        st = engines[1].stats()
        assert st["prefetch_errors"] == 0 and st["search_tiles"] == 24
    finally:
        for eng in engines:
            eng.close()
