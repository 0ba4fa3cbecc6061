"""The sharded index of the port against the JAX reference, on the CPU.

The reference's own mesh cannot serve as the oracle here (its shard_map
tests fail under the installed jax), so the oracle is built from the
reference's single-backend functions, as its ``core/distributed.py``
defines the mesh: every shard runs ``core.insert`` on the whole batch with
the ids it does not own set to -1, deletes are broadcast, and searches
merge the per-shard ``[Q, k]`` partials, concatenated in shard order, by
the reference's ``topk_ref`` (``lax.top_k``). Shards are
``ShardMesh.virtual(S, "cpu")``.

  * the sharded ops and ``sivf_torch.Index(backend=mesh)``: every shard's
    planes ``==`` the oracle's after every op (``norms`` allclose 1e-6,
    summation order), reports ``==`` the single index's with the
    per-shard error vector beside them, search labels ``==``, raw
    distances allclose 1e-5 and PQ distances bit for bit through one
    shared ADC table (``tests/parity.py``), PQ off, PQ, PQ with
    ``store_raw``;
  * a partial per-shard failure (one shard's pool exhausted) and deferred
    reports carrying ``shard_errors``;
  * the merge: ``merge_partials`` ``==`` ``topk_ref`` on ``-0.0`` /
    ``+0.0``, ``+inf`` with label -1 and ties across shards, and no
    ``torch.topk`` on the path;
  * the host resharding: ``flatten_live_rows``, ``reshard_state``,
    ``search_stacked`` and ``stats`` ``==`` the reference's on the same
    stacked planes, the fit checks' messages, a shrink that empties a
    shard.

Shapes follow ``tests/test_reshard.py`` (dim 16, 8 lists, slabs of 32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf
import sivf_torch
from repro import core as jcore
from repro.core import distributed as jdist
from repro.core import filters as jflt
from repro.core import index as jix
from repro.core import state as jstate
from repro.kernels.topk.ref import topk_ref as jtopk_ref
from repro_torch import interop
from repro_torch.core import distributed as dist
from repro_torch.core import pq as tpq
from repro_torch.core.state import PLANES, clear_error

from test_torch_state import assert_planes_equal, jax_planes

D, NL, B = 16, 8, 64
POOL = dict(n_slabs=48, capacity=32, n_max=4096, max_chain=16)
PQ_CASES = {"raw": None, "pq": (4, 6, False), "pq_store_raw": (4, 6, True)}

jinit = jax.jit(jcore.init_state, static_argnums=0)
jadc = jax.jit(jcore.pq.adc_tables, static_argnames=("metric",))


def cfgs(pq=None, attributes=(), **kw):
    """The reference's and the port's config."""
    base = dict(dim=D, n_lists=NL, attributes=attributes, **{**POOL, **kw})
    jcfg = sivf.SIVFConfig(**base, pq=None if pq is None else sivf.PQConfig(
        m=pq[0], nbits=pq[1], store_raw=pq[2]))
    return jcfg, interop.config_from_dict(dataclasses.asdict(jcfg))


def mesh(n: int) -> sivf_torch.ShardMesh:
    return sivf_torch.ShardMesh.virtual(n, "cpu")


def share_adc(monkeypatch):
    """The port's PQ searches take the reference's ADC table of their
    queries, so both scans sum the same looked-up values."""
    def adc_tables(codebooks, queries, metric):
        return torch.from_numpy(np.array(jadc(
            jnp.asarray(codebooks.numpy()), jnp.asarray(queries.numpy()),
            metric)))

    monkeypatch.setattr(tpq, "adc_tables", adc_tables)


def pad(a, n, fill=0):
    a = np.asarray(a)
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


class Oracle:
    """The reference's mesh from its single-backend functions: ``n``
    reference states, each fed every batch with the ids it does not own
    set to -1 (``repro/core/distributed.py:109-117``)."""

    def __init__(self, jcfg, cents, n, cb=None):
        self.jcfg, self.n = jcfg, n
        self.sts = [jinit(jcfg, jnp.asarray(cents),
                          None if cb is None else jnp.asarray(cb))
                    for _ in range(n)]

    def add(self, vecs, ids, attrs=None, clear=True) -> list:
        """One padded batch; returns each shard's error bits (cleared from
        the state after, as ``Index`` clears them, unless ``clear`` is
        false)."""
        ids = np.asarray(ids, np.int32)
        errs = []
        for s in range(self.n):
            mine = np.where((ids >= 0) & (ids % self.n == s), ids, -1)
            st = jcore.insert(self.jcfg, jstate.clear_error(self.sts[s]),
                              jnp.asarray(vecs, jnp.float32),
                              jnp.asarray(mine), None, None,
                              None if attrs is None else jnp.asarray(attrs))
            errs.append(int(st.error))
            self.sts[s] = jstate.clear_error(st) if clear else st
        return errs

    def remove(self, ids) -> None:
        ids = jnp.asarray(np.asarray(ids, np.int32))
        self.sts = [jcore.delete(self.jcfg, st, ids) for st in self.sts]

    def search(self, qs, k, nprobe, pred=None, bucket=B):
        """Merged results of the queries, padded to the handle's
        ``bucket`` as ``Index.search`` pads them (the ADC table of a
        padded batch is what the port is held to)."""
        fs = fc = None
        if pred is not None:
            cf = jflt.compile_filter(pred, self.jcfg.attributes)
            fs, fc = cf.structure, jnp.asarray(cf.consts, jnp.int32)
        q = jnp.asarray(pad(np.asarray(qs, np.float32), bucket))
        ds, ls = zip(*(jcore.search(self.jcfg, st, q, k, nprobe, fstruct=fs,
                                    fconsts=fc) for st in self.sts))
        d, lab = jtopk_ref(jnp.concatenate(ds, 1), jnp.concatenate(ls, 1),
                           k)
        return np.asarray(d)[:len(qs)], np.asarray(lab)[:len(qs)]

    def stacked(self):
        """The reference's stacked state, numpy leaves."""
        return jax.tree.map(lambda *xs: np.stack([np.asarray(x)
                                                  for x in xs]), *self.sts)

    def check(self, state) -> None:
        """Every shard of a port ``ShardedState`` ``==`` the oracle's."""
        assert state.n_shards == self.n
        for s in range(self.n):
            assert_planes_equal(jax_planes(self.sts[s]),
                                interop.state_to_numpy(state[s]))


def assert_search(got, want, pq: bool) -> None:
    d, lab = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in got)
    assert np.array_equal(lab, want[1])
    if pq:
        assert np.array_equal(d, want[0])
    else:
        np.testing.assert_allclose(d, want[0], rtol=1e-5, atol=1e-5)


def report_tuple(r) -> tuple:
    return (r.op, r.requested, r.accepted, r.overwritten, r.rejected,
            int(r.errors), r.n_live, r.padded_to)


def codebooks(rng, tcfg):
    if tcfg.pq is None:
        return None
    return rng.normal(size=tcfg.codebook_shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The mesh Index against the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(PQ_CASES))
def test_mesh_index_matches_per_shard_reference(rng, case, monkeypatch):
    """Adds (with overwrites and in-batch duplicates), removes, searches
    and filtered searches on 3 shards: planes ``==`` the oracle's after
    every op, reports ``==`` a single index's, results ``==``."""
    jcfg, tcfg = cfgs(PQ_CASES[case], ("tenant",))
    pq = tcfg.pq is not None
    if pq:
        share_adc(monkeypatch)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = codebooks(rng, tcfg)
    oracle = Oracle(jcfg, cents, 3, cb)
    m = sivf_torch.Index(tcfg, cents, backend=mesh(3), min_bucket=B,
                         pq_codebooks=cb)
    single = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=B,
                              pq_codebooks=cb)
    assert m.backend == "mesh" and m.n_shards == 3
    vecs = rng.normal(size=(200, D)).astype(np.float32)
    tenant = (np.arange(200) % 4).astype(np.int32)[:, None]
    batches = [np.arange(0, 64), np.arange(64, 128), np.arange(128, 190),
               np.r_[np.arange(0, 30, 3), 5, 5, 150]]     # overwrites, dups
    for ids in batches:
        v = vecs[ids] + (0.5 if ids[0] == 0 and len(ids) < 64 else 0.0)
        rm = m.add(v, ids, attrs=tenant[ids])
        rs = single.add(v, ids, attrs=tenant[ids])
        assert report_tuple(rm) == report_tuple(rs)
        assert rm.shard_errors == (sivf_torch.ErrorCode.NONE,) * 3
        errs = oracle.add(pad(v, B), pad(ids, B, -1), pad(tenant[ids], B))
        assert errs == [0, 0, 0]
        oracle.check(m.state)
    gone = np.r_[np.arange(0, 190, 7), 4000]                # one absent id
    assert report_tuple(m.remove(gone)) == report_tuple(single.remove(gone))
    oracle.remove(pad(gone, B, -1))
    oracle.check(m.state)
    qs = rng.normal(size=(6, D)).astype(np.float32)
    for k, nprobe in ((5, NL), (10, 3), (1, 2)):
        assert_search(m.search(qs, k, nprobe), oracle.search(qs, k, nprobe),
                      pq)
    pred = sivf.Eq("tenant", 1)
    assert_search(m.search(qs, 5, NL, filter=sivf_torch.Eq("tenant", 1)),
                  oracle.search(qs, 5, NL, pred), pq)
    st = m.stats()
    assert (st["backend"], st["n_shards"], st["n_live"]) == \
        ("mesh", 3, single.n_live) and sum(st["per_shard_live"]) == m.n_live
    assert st["list_occupancy"] == single.stats()["list_occupancy"]


def test_sharded_ops_and_plans_match_the_reference(rng):
    """The functional surface on 4 shards: bad ids (one past ``n_max``,
    owned by shard 3; -5, owned by nobody) raise ``ID_RANGE`` on the owner
    only; ``want_plan`` gives the stacked ``[S, B]`` plan of each shard's
    ``_insert_impl(want_plan=True)``; the legacy ``dist_*`` agree."""
    jcfg, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    oracle = Oracle(jcfg, cents, 4)
    msh = mesh(4)
    state = dist.init_sharded_state(tcfg, cents, msh)
    vecs = rng.normal(size=(B, D)).astype(np.float32)
    ids = np.arange(B, dtype=np.int32)
    ids[[3, 9]] = (tcfg.n_max + 3, -5)
    state, plan = dist.sharded_insert(tcfg, msh, want_plan=True)(
        state, torch.from_numpy(vecs), torch.from_numpy(ids))
    errs = state.error.tolist()
    assert errs == [0, 0, 0, int(sivf_torch.ErrorCode.ID_RANGE)]
    assert oracle.add(vecs, ids, clear=False) == errs
    oracle.check(state)
    assert tuple(plan["slab"].shape) == (4, B)
    for s in range(4):
        mine = np.where((ids >= 0) & (ids % 4 == s), ids, -1)
        st0 = jinit(jcfg, jnp.asarray(cents))
        lists = jcore.assign(st0.centroids, jnp.asarray(vecs), "l2")
        _, jplan = jix._insert_impl(jcfg, st0, jnp.asarray(vecs),
                                    jnp.asarray(mine), lists,
                                    want_plan=True)
        assert np.array_equal(plan["slab"][s].numpy(),
                              np.asarray(jplan["slab"]))
        assert np.array_equal(plan["slot"][s].numpy(),
                              np.asarray(jplan["slot"]))
    state = dist.ShardedState([clear_error(sh) for sh in state.shards])
    oracle.sts = [jstate.clear_error(st) for st in oracle.sts]
    gone = pad(np.arange(0, 64, 5), B, -1)
    state = dist.dist_delete(tcfg, msh, state, torch.from_numpy(gone))
    oracle.remove(gone)
    oracle.check(state)
    more = rng.normal(size=(B, D)).astype(np.float32)
    state = dist.dist_insert(tcfg, msh, state, torch.from_numpy(more),
                             torch.arange(100, 100 + B, dtype=torch.int32))
    oracle.add(more, np.arange(100, 100 + B))
    oracle.check(state)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    assert_search(dist.dist_search(tcfg, msh, state, torch.from_numpy(qs),
                                   5, NL), oracle.search(qs, 5, NL), False)
    assert dist.total_live(state) == int(np.asarray(
        oracle.stacked().n_live).sum())
    assert dist.shard_of(torch.tensor([-1, 0, 5, 7]), 4).tolist() == \
        [-1, 0, 1, 3]


def test_partial_shard_failure_is_reported_per_shard(rng):
    """The reference's partial-failure case (``tests/test_api.py``): shard 0
    is overloaded past its own pool while shards 1-3 commit, under
    deferral. The report counts shard 0's rows rejected (its overwrites
    kept their old payloads), the others' accepted, and ``shard_errors``
    names shard 0; every shard's planes ``==`` the oracle's."""
    jcfg, tcfg = cfgs(n_slabs=4, max_chain=2)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    oracle = Oracle(jcfg, cents, 4)
    idx = sivf_torch.Index(tcfg, cents, backend=mesh(4), min_bucket=8,
                           deferred=True)
    base_ids = np.asarray([0, 4, 8, 1, 2, 3], np.int32)     # 3 on shard 0
    base = rng.normal(size=(len(base_ids), D)).astype(np.float32)
    f0 = idx.add(base, base_ids)
    over = np.arange(0, 4 * 4 * 32 + 4, 4, dtype=np.int32)  # all shard 0
    others = np.asarray([5, 6, 7], np.int32)
    batch_ids = np.concatenate([over, others])
    bv = rng.normal(size=(len(batch_ids), D)).astype(np.float32)
    f1 = idx.add(bv, batch_ids)
    assert not f0.done and idx.pending_count == 2
    reps = idx.flush()
    assert reps == [f0.result(), f1.result()]
    assert f0.result().ok and f0.result().accepted == len(base_ids)
    rep = f1.result()
    pool = sivf_torch.ErrorCode.POOL_EXHAUSTED
    assert rep.errors & pool and rep.shard_errors[0] & pool
    assert not any(e & pool for e in rep.shard_errors[1:])
    assert (rep.accepted, rep.overwritten, rep.rejected) == \
        (len(others), 0, len(over))
    assert idx.n_live == len(base_ids) + len(others)
    oracle.add(pad(base, 8), pad(base_ids, 8, -1))
    n = idx._bucket(len(batch_ids))
    assert oracle.add(pad(bv, n), pad(batch_ids, n, -1)) == \
        [int(e) for e in rep.shard_errors]
    oracle.check(idx.state)
    d, lab = idx.search(base[:3], 1, NL)                    # ids 0, 4, 8
    assert lab[:, 0].tolist() == [0, 4, 8]
    np.testing.assert_allclose(d[:, 0].numpy(), 0, atol=1e-4)


def test_deferred_mesh_matches_eager(rng, monkeypatch):
    """Deferred reports, per-shard error vectors included, ``==`` eager
    ones; the queue resolves in one device->host copy."""
    _, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    eager = sivf_torch.Index(tcfg, cents, backend=mesh(2), min_bucket=8)
    deferred = sivf_torch.Index(tcfg, cents, backend=mesh(2), min_bucket=8,
                                deferred=True)
    vecs = rng.normal(size=(40, D)).astype(np.float32)
    ops = [("add", (vecs[:30], np.arange(30))), ("remove", (np.arange(5),)),
           ("add", (vecs[10:40], np.r_[np.arange(10, 38), 5000, -3])),
           ("remove", (np.arange(0, 40, 3),))]
    want = [getattr(eager, op)(*a) for op, a in ops]
    futs = [getattr(deferred, op)(*a) for op, a in ops]
    copies = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: copies.append(t.shape)
                        or real(t, *a, **k))
    got = deferred.flush()
    monkeypatch.undo()
    # four batches, each its six aux scalars and its two shards' bits
    assert len(copies) == 1 and copies[0] == (4 * (6 + 2),)
    assert got == want == [f.result() for f in futs]
    assert got[2].shard_errors == (sivf_torch.ErrorCode.ID_RANGE,
                                   sivf_torch.ErrorCode.NONE)  # 5000 % 2
    assert got[2].errors == sivf_torch.ErrorCode.ID_RANGE


# ---------------------------------------------------------------------------
# The cross-shard merge
# ---------------------------------------------------------------------------

def merge_cases(rng):
    """Per-shard ``[Q, k]`` partials (each sorted, as a shard's search
    returns them): ``-0.0`` on one shard and ``+0.0`` on another, partial
    lists padded with ``+inf`` / -1, ties across shards, S*k not a
    multiple of 4."""
    inf = np.inf
    yield "signed_zero", 2, [
        (np.array([[0.0, 1.0]], np.float32), [[7, 8]]),
        (np.array([[-0.0, 0.0]], np.float32), [[9, 10]]),
        (np.array([[-0.0, 2.0]], np.float32), [[11, 12]])]
    yield "partial_lists", 3, [
        (np.array([[0.5, inf, inf]], np.float32), [[1, -1, -1]]),
        (np.array([[inf, inf, inf]], np.float32), [[-1, -1, -1]]),
        (np.array([[0.25, 0.5, inf]], np.float32), [[2, 3, -1]])]
    yield "ties", 4, [(np.array([[1.0, 1.0, 2.0, 2.0]], np.float32),
                       [[s * 10 + j for j in range(4)]]) for s in range(3)]
    for s_count, k in ((3, 10), (4, 1), (3, 7)):
        parts = []
        for s in range(s_count):
            d = np.sort(rng.normal(size=(6, k)).astype(np.float32), 1)
            d[:, k // 2:] = np.where(rng.random((6, k - k // 2)) < 0.3, inf,
                                     d[:, k // 2:])
            d = np.sort(d, 1)
            lab = np.where(np.isinf(d), -1, rng.integers(0, 1000, (6, k)))
            parts.append((d, lab))
        yield f"random_s{s_count}_k{k}", k, parts


@pytest.mark.parametrize("case", ["signed_zero", "partial_lists", "ties",
                                  "random_s3_k10", "random_s4_k1",
                                  "random_s3_k7"])
def test_merge_equals_topk_ref(rng, case):
    k, parts = next((k, p) for name, k, p in merge_cases(rng) if name == case)
    ds = [torch.from_numpy(np.asarray(d, np.float32)) for d, _ in parts]
    ls = [torch.from_numpy(np.asarray(lab, np.int32)) for _, lab in parts]
    d, lab = dist.merge_partials(ds, ls, k)
    jd, jl = jtopk_ref(jnp.concatenate([jnp.asarray(x.numpy()) for x in ds],
                                       1),
                       jnp.concatenate([jnp.asarray(x.numpy()) for x in ls],
                                       1), k)
    assert np.array_equal(lab.numpy(), np.asarray(jl))
    assert np.array_equal(d.numpy().view(np.int32),
                          np.asarray(jd).view(np.int32))   # -0.0 bits too
    if case == "signed_zero":
        assert lab[0].tolist() == [9, 11]                   # -0.0 first
        # the host merge of search_stacked (a stable sort) ties the zeros
        dg = torch.cat(ds, 1).numpy()
        order = np.argsort(dg, 1, kind="stable")[0, :2]
        assert torch.cat(ls, 1)[0, order].tolist() == [7, 9]
    if case == "partial_lists":
        assert lab.tolist() == [[2, 1, 3]]


def test_mesh_search_merges_with_the_ports_topk(rng, monkeypatch):
    """A mesh search goes through ``kernels.topk.ops.topk`` (the plain
    version on CPU tensors), never ``torch.topk``."""
    from repro_torch.kernels.topk import ops as topk_ops
    _, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    idx = sivf_torch.Index(tcfg, cents, backend=mesh(3), min_bucket=8)
    idx.add(rng.normal(size=(90, D)).astype(np.float32), np.arange(90))
    calls = []
    real = topk_ops.topk
    monkeypatch.setattr(topk_ops, "topk",
                        lambda d, lab, k: calls.append(tuple(d.shape))
                        or real(d, lab, k))

    def no_torch_topk(*a, **k):
        raise AssertionError("torch.topk on the mesh path")

    monkeypatch.setattr(torch, "topk", no_torch_topk)
    res = idx.search(rng.normal(size=(5, D)).astype(np.float32), 10, NL)
    assert calls == [(8, 30)]                # padded to the 8-row bucket
    assert tuple(res.labels.shape) == (5, 10)


# ---------------------------------------------------------------------------
# Host resharding against the reference's
# ---------------------------------------------------------------------------

def filled(rng, case, n_shards, attributes=()):
    """An oracle and the port's ShardedState after the same churn."""
    jcfg, tcfg = cfgs(PQ_CASES[case], attributes)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    cb = codebooks(rng, tcfg)
    oracle = Oracle(jcfg, cents, n_shards, cb)
    msh = mesh(n_shards)
    state = dist.init_sharded_state(tcfg, cents, msh, pq_codebooks=cb)
    ins = dist.sharded_insert(tcfg, msh)
    vecs = rng.normal(size=(4 * B, D)).astype(np.float32)
    for lo in range(0, 4 * B, B):
        ids = np.arange(lo, lo + B, dtype=np.int32)
        at = (ids % 3)[:, None].astype(np.int32) if attributes else None
        state = ins(state, torch.from_numpy(vecs[lo:lo + B]),
                    torch.from_numpy(ids),
                    None if at is None else torch.from_numpy(at))
        oracle.add(vecs[lo:lo + B], ids, at)
    gone = pad(np.arange(0, 4 * B, 7), B, -1)
    state = dist.sharded_delete(tcfg, msh)(state, torch.from_numpy(gone))
    oracle.remove(gone)
    oracle.check(state)
    return jcfg, tcfg, oracle, state


def assert_tables_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.shape == y.shape and x.dtype == y.dtype, key
        assert np.array_equal(x, y), key


@pytest.mark.parametrize("case", sorted(PQ_CASES))
def test_flatten_and_reshard_chain_equal_the_reference(rng, case,
                                                        monkeypatch):
    """``flatten_live_rows`` of the port's shards, of the reference's
    stacked planes and of the reference's own function agree; each step of
    the chain 4 -> 2 -> 3 -> 1 -> 4 gives per-shard planes ``==`` the
    reference's ``reshard_state`` (``norms``, from the decoded codewords
    under PQ, allclose 1e-6: summation order), and ``search_stacked``
    ``==`` the reference's."""
    jcfg, tcfg, oracle, state = filled(rng, case, 4, ("tenant",))
    pq = tcfg.pq is not None
    if pq:
        share_adc(monkeypatch)
    jst = oracle.stacked()
    want = jdist.flatten_live_rows(jcfg, jst)
    assert_tables_equal(dist.flatten_live_rows(tcfg, state), want)
    planes = {k: np.asarray(getattr(jst, k)) for k in PLANES}
    assert_tables_equal(dist.flatten_live_rows(tcfg, planes), want)
    qs = rng.normal(size=(5, D)).astype(np.float32)
    n = 4
    for n_to in (2, 3, 1, 4):
        jst = jdist.reshard_state(jcfg, jst, n, n_to, stack=n_to > 1)
        state = dist.reshard_state(tcfg, state, n, n_to, stack=n_to > 1)
        if n_to == 1:
            assert not isinstance(state, dist.ShardedState)
            assert_planes_equal(jax_planes(jst),
                                interop.state_to_numpy(state))
        else:
            for s in range(n_to):
                assert_planes_equal(
                    jax_planes(jax.tree.map(lambda x: x[s], jst)),
                    interop.state_to_numpy(state[s]))
        assert_tables_equal(dist.flatten_live_rows(tcfg, state), want)
        jd, jl = jdist.search_stacked(jcfg, jst, qs, 5, NL)
        assert_search(dist.search_stacked(tcfg, state, qs, 5, NL),
                      (np.asarray(jd), np.asarray(jl)), pq)
        n = n_to


def test_flatten_refuses_a_corrupt_state(rng):
    _, tcfg, _, state = filled(rng, "raw", 2)
    state[1].n_live += 1
    with pytest.raises(ValueError, match="corrupt state"):
        dist.flatten_live_rows(tcfg, state)


def test_reshard_fit_checks_match_the_reference(rng):
    """Shrinking onto fewer shards than the rows fit: the same two
    ``ValueError`` messages as the reference's, before any rebuild; and
    the shard-count checks."""
    for kw, n_rows, same_list, what in (
            (dict(n_slabs=16), 200, False, "n_slabs"),
            (dict(max_chain=1), 20, True, "max_chain")):
        jcfg, tcfg = cfgs(**kw)
        cents = rng.normal(size=(NL, D)).astype(np.float32)
        oracle = Oracle(jcfg, cents, 4)
        one = rng.normal(size=(1, D)).astype(np.float32)
        for lo in range(0, 4 * n_rows, 4 * 50):
            ids = np.arange(lo, min(lo + 4 * 50, 4 * n_rows), dtype=np.int32)
            v = np.repeat(one, len(ids), 0) if same_list else \
                rng.normal(size=(len(ids), D)).astype(np.float32)
            assert oracle.add(pad(v, 256), pad(ids, 256, -1)) == [0] * 4
        jst = oracle.stacked()
        with pytest.raises(ValueError) as ej:
            jdist.reshard_state(jcfg, jst, 4, 1)
        planes = {k: np.asarray(getattr(jst, k)) for k in PLANES}
        with pytest.raises(ValueError) as et:
            dist.reshard_state(tcfg, planes, 4, 1)
        assert str(et.value) == str(ej.value) and what in str(et.value)
    with pytest.raises(ValueError, match="n_from"):
        dist.reshard_state(tcfg, planes, 2, 4)
    with pytest.raises(ValueError, match="n_to"):
        dist.reshard_state(tcfg, planes, 4, 0)


def test_shrink_leaves_a_shard_empty(rng):
    """Every id a multiple of 4: on 2 shards, shard 1 owns nothing; it is a
    well-formed empty pool that searches and takes its first insert."""
    jcfg, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    idx = sivf_torch.Index(tcfg, cents, device="cpu", min_bucket=B)
    vecs = rng.normal(size=(60, D)).astype(np.float32)
    idx.add(vecs, np.arange(0, 240, 4))
    qs = rng.normal(size=(4, D)).astype(np.float32)
    d0, l0 = idx.search(qs, 5, NL)
    st4 = dist.reshard_state(tcfg, idx.state, 1, 4)
    assert st4.n_live.tolist() == [60, 0, 0, 0]
    st2 = dist.reshard_state(tcfg, st4, 4, 2)
    assert st2.n_live.tolist() == [60, 0]
    fresh = interop.state_to_numpy(sivf_torch.init_state(tcfg, cents,
                                                         device="cpu"))
    assert_planes_equal(fresh, interop.state_to_numpy(st2[1]))
    d, lab = dist.search_stacked(tcfg, st2, qs, 5, NL)
    assert np.array_equal(lab, l0.numpy()) and np.array_equal(d, d0.numpy())
    from repro_torch.core import index as tix
    one = tix.insert(tcfg, st2[1], torch.from_numpy(vecs[:1]),
                     torch.tensor([1], dtype=torch.int32))
    assert int(one.n_live) == 1 and int(one.error) == 0


def test_stats_match_the_reference_on_stacked_state(rng):
    jcfg, tcfg, oracle, state = filled(rng, "pq", 3)
    want = jix.stats(jcfg, oracle.stacked())
    got = dist.stats(tcfg, state)
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key


def test_mesh_construction_and_backend_checks(rng):
    """``ShardMesh`` reads like a jax ``Mesh`` to the backend checks; the
    reference's messages for a wrong axis and a bad backend; an explicit
    device that disagrees with the mesh's raises."""
    _, tcfg = cfgs()
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    m3 = mesh(3)
    assert m3.shape == {"data": 3} and m3.size == 3
    assert m3 == sivf_torch.ShardMesh(("cpu",) * 3) and hash(m3)
    other = sivf_torch.ShardMesh.virtual(2, "cpu", axis="model")
    with pytest.raises(ValueError, match="no 'data' axis"):
        sivf_torch.Index(tcfg, cents, backend=other)
    assert sivf_torch.Index(tcfg, cents, backend=other,
                            axis="model").n_shards == 2
    with pytest.raises(TypeError, match="backend must be"):
        sivf_torch.Index(tcfg, cents, backend="mesh", device="cpu")
    with pytest.raises(ValueError, match="disagrees"):
        sivf_torch.Index(tcfg, cents, backend=m3, device="cuda")
    ok = sivf_torch.Index(tcfg, cents, backend=m3, device="cpu")
    assert ok.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sivf_torch.Index(tcfg, cents,
                             backend=sivf_torch.ShardMesh.virtual(2))
    with pytest.raises(ValueError, match="shards but mesh axis"):
        dist.place_sharded(tcfg, ok.state, mesh(2))


def test_train_replicates_codebooks(rng):
    """``train`` on a mesh gives every shard the codebooks a single index
    trains from the same sample and generator."""
    _, tcfg = cfgs(PQ_CASES["pq"])
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    sample = rng.normal(size=(300, D)).astype(np.float32)
    single = sivf_torch.Index(tcfg, cents, device="cpu").train(sample)
    m = sivf_torch.Index(tcfg, cents, backend=mesh(3)).train(sample)
    for s in range(3):
        assert torch.equal(m.state[s].pq_codebooks,
                           single.state.pq_codebooks)
    assert m.state[0].pq_codebooks.data_ptr() != \
        m.state[1].pq_codebooks.data_ptr()
    m.add(sample[:20], np.arange(20))
    with pytest.raises(RuntimeError, match="non-empty"):
        m.train(sample)


def test_reshard_telemetry_matches_the_reference(rng, monkeypatch):
    """``reshard.flatten`` / ``reshard.build_shard`` spans and the
    ``sivf_reshard_rows_total`` and ``sivf_transfer_bytes_total{stage=
    "reshard"}`` counters: the reference's values on the same rows. Both
    record into a fresh enabled process default, swapped in for the test
    only (the real defaults stay untouched for other tests)."""
    from repro import obs as jobs
    from repro_torch import obs as tobs
    jcfg, tcfg, oracle, state = filled(rng, "raw", 2)
    tel_t, tel_j = tobs.Telemetry(enabled=True), jobs.Telemetry(enabled=True)
    monkeypatch.setattr(tobs, "_default", tel_t)
    monkeypatch.setattr(jobs, "_default", tel_j)
    dist.reshard_state(tcfg, state, 2, 3)
    jdist.reshard_state(jcfg, oracle.stacked(), 2, 3)
    snap_t, snap_j = tel_t.snapshot(), tel_j.snapshot()
    for name in ("sivf_reshard_rows_total", "sivf_transfer_bytes_total"):
        assert snap_t["metrics"][name]["series"] == \
            snap_j["metrics"][name]["series"], name

    def stages(snap):
        return {x["labels"]["stage"]: x["count"]
                for x in snap["metrics"]["sivf_stage_seconds"]["series"]}
    assert stages(snap_t) == stages(snap_j) == {"reshard.flatten": 1,
                                                "reshard.build_shard": 3}


def test_merge_never_falls_back_off_the_cpu(monkeypatch):
    """Partials that do not lie on the CPU (``meta`` tensors: no card is
    needed to make them) go to kernel 4's wrapper, never to its plain
    version: an error the wrapper raises propagates."""
    from repro_torch.kernels.topk import ops as topk_ops
    from repro_torch.kernels.topk import topk as topk_kernel

    class Launched(Exception):
        pass

    def launch(*args, **kwargs):
        raise Launched("topk")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a non-CPU tensor")

    parts = ([torch.empty(4, 10, device="meta")] * 3,
             [torch.empty(4, 10, dtype=torch.int32, device="meta")] * 3)
    monkeypatch.setattr(topk_kernel, "topk_cuda", launch)
    monkeypatch.setattr(topk_ops, "topk_ref", plain)
    with pytest.raises(Launched):
        dist.merge_partials(*parts, 10)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):   # the real wrapper
        dist.merge_partials(*parts, 10)
