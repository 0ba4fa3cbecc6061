"""The port's filter slice against the JAX reference, on the CPU.

  * the predicate algebra: the port's copy of ``core/filters.py`` gives
    ``==`` structures and constants, ``==`` ``host_matches`` masks, the
    same ``eq_bindings`` and ``normalize_attrs`` results, and the same
    errors;
  * the in-scan mask: the same filled state (attributes, deleted slots)
    and the same compiled predicate go through the reference's XLA scans
    and the port's (the plain versions the CUDA kernels equal bit for
    bit). Raw payloads: labels ``==``, distances allclose(rtol=atol=1e-5)
    (the port sums dot products in eight lanes over d, the reference in
    XLA's blocks). PQ: fed the reference's
    ADC table, distances and labels ``==``. Every node type, a nested
    ``And``, a predicate no row passes and k beyond the passing rows;
  * the ``Index``: filtered recall@10 is 1.0 against the
    brute-force-within-predicate oracle at full probe.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sivf_torch
from repro.core import filters as jflt
from repro_torch.core import filters as flt
from repro_torch.core import index as tix
from repro_torch.kernels.sivf_scan import fused

from test_torch_pq import (
    ATTRS,
    D,
    NL,
    assert_pq_scan_matches,
    filled_twin,
    filter_args,
    jscan,
)


def both(pred):
    """``pred`` (built from the port's classes) and its reference twin."""
    if isinstance(pred, flt.And):
        return pred, jflt.And(*(both(p)[1] for p in pred.preds))
    return pred, getattr(jflt, type(pred).__name__)(
        **dataclasses.asdict(pred))


PREDS = {
    "eq": flt.Eq("tenant", 2),
    "in": flt.In("tenant", (0, 3)),
    "range": flt.Range("ts", 20, 70),
    "and": flt.And(flt.Eq("tenant", 1), flt.Range("ts", 0, 50)),
    "nested-and": flt.And(flt.In("tenant", (1, 2, 4)),
                          flt.And(flt.Range("ts", 10, 90),
                                  flt.In("ts", tuple(range(0, 100, 3))))),
    "none-pass": flt.Eq("tenant", 99),
}


# ---------------------------------------------------------------------------
# Predicate algebra
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PREDS))
def test_compile_filter_and_oracle_match_reference(rng, name):
    pred, jpred = both(PREDS[name])
    cf, jcf = flt.compile_filter(pred, ATTRS), jflt.compile_filter(jpred,
                                                                   ATTRS)
    assert (cf.structure, cf.consts) == (jcf.structure, jcf.consts)
    assert hash(cf.structure) == hash(jcf.structure)
    attrs = np.stack([rng.integers(0, 5, 500), rng.integers(0, 100, 500)], 1)
    got = flt.host_matches(pred, ATTRS, attrs)
    assert np.array_equal(got, jflt.host_matches(jpred, ATTRS, attrs))
    assert flt.eq_bindings(pred) == jflt.eq_bindings(jpred)
    # the kernels' flat program: one (kind, attr, n_consts) per leaf, in
    # the order the constants are consumed
    prog = flt.leaf_program(cf.structure)
    assert len(prog) % 3 == 0 and sum(prog[2::3]) == len(cf.consts)
    assert set(prog[0::3]) <= set(flt.LEAF_KINDS.values())


def test_algebra_errors_match_reference():
    for mod in (flt, jflt):
        assert mod.compile_filter(None, ATTRS) is None
        with pytest.raises(KeyError, match="unknown attribute 'nope'"):
            mod.compile_filter(mod.Eq("nope", 1), ATTRS)
        with pytest.raises(ValueError, match="at least one value"):
            mod.In("tenant", ())
        with pytest.raises(ValueError, match="at least one predicate"):
            mod.And()
        with pytest.raises(TypeError, match="not a predicate"):
            mod.compile_filter("tenant == 1", ATTRS)
    assert flt.leaf_program(("and", ("eq", 0), ("and", ("in", 1, 3),
                                                ("range", 0)))) \
        == (0, 0, 1, 1, 1, 3, 2, 0, 2)
    with pytest.raises(ValueError, match="bad filter structure"):
        flt.leaf_program(("or", ("eq", 0)))


def test_normalize_attrs_matches_reference():
    cases = [({"tenant": 3, "ts": [1, 2]}, 2, None),
             (np.array([[1, 2], [3, 4]], np.int64), 2, None),
             ({"tenant": 99, "ts": 5}, 2, {"tenant": 1}),
             ({"ts": 5}, 3, {"tenant": 1}),
             (np.array([[7, 8]]), 1, {"ts": 0})]
    for attrs, n, over in cases:
        got = flt.normalize_attrs(ATTRS, attrs, n, overrides=over)
        want = jflt.normalize_attrs(ATTRS, attrs, n, overrides=over)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    for attrs, n, err in (({"tenant": 1}, 2, ValueError),
                          ({"tenant": 1, "ts": 0, "shard": 2}, 2, KeyError),
                          (np.zeros((1, 2)), 2, ValueError)):
        for mod in (flt, jflt):
            with pytest.raises(err):
                mod.normalize_attrs(ATTRS, attrs, n)


# ---------------------------------------------------------------------------
# The in-scan mask against the reference's scans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raw_twin():
    return filled_twin(np.random.default_rng(2))


@pytest.fixture(scope="module")
def pq_twin_l2():
    return filled_twin(np.random.default_rng(1), m=4, nbits=4)


def passing_live(tw, pred) -> np.ndarray:
    live = tw.live_ids()
    return live[flt.host_matches(pred, ATTRS, tw.attrs[live])]


@pytest.mark.parametrize("name", sorted(PREDS))
def test_filtered_scan_matches_reference(rng, raw_twin, name):
    tw, pred = raw_twin, PREDS[name]
    cf = flt.compile_filter(pred, ATTRS)
    qs = rng.normal(size=(6, D)).astype(np.float32)
    n_pass = len(passing_live(tw, pred))
    k = 7 if name != "and" else n_pass + 5          # k > passing rows
    table = tw.table(qs, NL)                        # full probe
    jkw, tkw = filter_args(cf)
    jd, jl = jscan(tw.jcfg, tw.js, jnp.asarray(qs), table, k, **jkw)
    launches = fused.launches + fused.filtered_launches
    td, tl = tix.scan_slabs_topk(tw.cfg, tw.ts, torch.from_numpy(qs),
                                 torch.from_numpy(np.array(table)), k, **tkw)
    assert fused.launches + fused.filtered_launches == launches
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    lab = tl.numpy()
    got = lab[lab >= 0]
    assert np.isin(got, passing_live(tw, pred)).all()  # deleted ids too
    assert (lab >= 0).sum(1).tolist() == [min(k, n_pass)] * len(qs)
    if name == "none-pass":
        assert n_pass == 0 and np.isinf(td.numpy()).all()


@pytest.mark.parametrize("name", ["in", "nested-and", "none-pass"])
def test_filtered_pq_scan_is_bit_exact(rng, pq_twin_l2, name):
    pred = PREDS[name]
    n_pass = len(passing_live(pq_twin_l2, pred))
    d, lab = assert_pq_scan_matches(pq_twin_l2, rng, k=n_pass + 3,
                                    nprobe=NL,
                                    cf=flt.compile_filter(pred, ATTRS))
    assert np.isin(lab[lab >= 0], passing_live(pq_twin_l2, pred)).all()
    assert np.isinf(d[:, n_pass:]).all()


# ---------------------------------------------------------------------------
# The Index
# ---------------------------------------------------------------------------

def make_index(rng, attributes=ATTRS, n=300):
    cfg = sivf_torch.SIVFConfig(dim=D, n_lists=NL, n_slabs=40, capacity=32,
                                n_max=2048, attributes=attributes)
    cents = rng.normal(size=(NL, D)).astype(np.float32)
    return sivf_torch.Index(cfg, cents, device="cpu", min_bucket=8)


def test_index_filtered_recall_is_exact(rng):
    """Filtered recall@10 is 1.0 against the brute-force-within-predicate
    oracle at full probe (as ``tests/test_filters.py`` holds the
    reference)."""
    idx = make_index(rng)
    n = 300
    vecs = rng.normal(size=(n, D)).astype(np.float32)
    tenant = rng.integers(0, 10, n).astype(np.int32)
    ts = rng.integers(0, 100, n).astype(np.int32)
    idx.add(vecs, np.arange(n), attrs={"tenant": tenant, "ts": ts})
    idx.remove(np.arange(0, n, 7))
    live = np.ones(n, bool)
    live[::7] = False
    attrs = np.stack([tenant, ts], axis=1)
    qs = rng.normal(size=(8, D)).astype(np.float32)
    k = 10
    for pred in list(PREDS.values()) + [sivf_torch.Eq("tenant", 3)]:
        mask = flt.host_matches(pred, ATTRS, attrs) & live
        dmat = ((qs[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
        want = np.argsort(np.where(mask[None], dmat, np.inf), axis=1,
                          kind="stable")[:, :k]
        _, lab = idx.search(qs, k, NL, filter=pred)
        lab = lab.numpy()
        n_pass = min(int(mask.sum()), k)
        for qi in range(len(qs)):
            assert set(lab[qi][lab[qi] >= 0].tolist()) == \
                set(want[qi, :n_pass].tolist()), pred


def test_index_attrs_api_contract(rng):
    idx = make_index(rng)
    vecs = rng.normal(size=(4, D)).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="requires attrs="):
        idx.add(vecs, ids)
    with pytest.raises(ValueError, match="missing attributes"):
        idx.add(vecs, ids, attrs={"tenant": 1})
    with pytest.raises(ValueError, match="attrs shape"):
        idx.add(vecs, ids, attrs=torch.zeros((3, 2), dtype=torch.int32))
    idx.add(vecs, ids, attrs={"tenant": 1, "ts": [0, 1, 2, 3]})
    idx.add(vecs[:2] + 1, ids[2:], attrs=torch.tensor([[2, 9], [2, 9]]))
    assert idx.n_live == 4
    assert idx.state.attrs[idx.state.att_slab[3], idx.state.att_slot[3]
                           ].tolist() == [2, 9]
    cf = sivf_torch.compile_filter(sivf_torch.Eq("tenant", 2), ATTRS)
    _, lab = idx.search(vecs, 4, NL, filter=cf)
    assert sorted(lab[0][lab[0] >= 0].tolist()) == [2, 3]
    plain = make_index(rng, attributes=())
    with pytest.raises(ValueError, match="attributes"):
        plain.search(vecs, 1, filter=sivf_torch.Eq("tenant", 1))
    with pytest.raises(ValueError, match="attrs= given"):
        plain.add(vecs, ids, attrs={"tenant": 1})
    with pytest.raises(KeyError, match="unknown attribute"):
        idx.search(vecs, 1, filter=sivf_torch.Eq("shard", 1))
