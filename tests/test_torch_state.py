"""Port state, bitmaps, utilities and interop against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages; the
port runs on the CPU (``device="cpu"``). Integer planes and ``data``
compare ``==``; ``norms`` allclose(rtol=1e-6) (summation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import utils as jutils
from repro.core import bitmap as jbm
from repro_torch import interop, utils
from repro_torch.core import bitmap as bm
from repro_torch.core import state as st


def jax_planes(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in st.PLANES}


def assert_planes_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b) == list(st.PLANES)
    for name in st.PLANES:
        x, y = a[name], b[name]
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if name == "norms":
            np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=name)
        else:
            assert np.array_equal(x, y), name


def configs(rng, **kw):
    jcfg = jcore.SIVFConfig(**kw)
    return jcfg, interop.config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("capacity,metric", [(32, "l2"), (64, "ip"),
                                             (128, "l2")])
def test_fresh_state_equals_reference(rng, capacity, metric):
    jcfg, tcfg = configs(rng, dim=16, n_lists=5, n_slabs=12,
                         capacity=capacity, n_max=300, metric=metric,
                         max_chain=6)
    cents = rng.normal(size=(5, 16)).astype(np.float32)
    ref = jax_planes(jcore.init_state(jcfg, jnp.asarray(cents)))
    port = interop.state_to_numpy(st.init_state(tcfg, cents, device="cpu"))
    assert_planes_equal(ref, port)
    assert len(st.PLANES) == 23


def test_state_round_trip_is_identity(rng):
    jcfg, tcfg = configs(rng, dim=8, n_lists=3, n_slabs=10, capacity=32,
                         n_max=256, max_chain=5)
    js = jcore.init_state(jcfg, jnp.asarray(rng.normal(size=(3, 8)),
                                            jnp.float32))
    vecs = rng.normal(size=(150, 8)).astype(np.float32)
    js = jcore.insert(jcfg, js, jnp.asarray(vecs),
                      jnp.arange(150, dtype=jnp.int32))
    js = jcore.delete(jcfg, js, jnp.arange(0, 150, 3, dtype=jnp.int32))
    planes = jax_planes(js)
    assert (planes["bitmap"] >= np.uint32(1 << 31)).any()   # bit 31 crosses
    back = interop.state_to_numpy(
        interop.state_from_numpy(tcfg, planes, device="cpu"))
    assert_planes_equal(planes, back)
    assert back["bitmap"].dtype == np.uint32


def test_config_round_trip_and_limits():
    cfg = st.SIVFConfig(dim=16, n_lists=4, n_slabs=8, capacity=64)
    d = interop.config_to_dict(cfg)
    assert d["dtype"] == "float32"
    assert interop.config_from_dict(d) == cfg
    assert jcore.SIVFConfig(**{**d, "dtype": jnp.float32}).words == cfg.words
    for bad in (0, 9):              # device_slabs must be in [1, n_slabs]
        with pytest.raises(ValueError, match="device_slabs"):
            st.SIVFConfig(dim=16, n_lists=4, n_slabs=8, device_slabs=bad)
        with pytest.raises(ValueError, match="device_slabs"):
            jcore.SIVFConfig(dim=16, n_lists=4, n_slabs=8, device_slabs=bad)
    for good in (1, 8):
        assert st.SIVFConfig(dim=16, n_lists=4, n_slabs=8,
                             device_slabs=good).payload_slabs == 0
    for kw in ({"capacity": 48}, {"pq": st.PQConfig(m=5)},
               {"attributes": ("a", "a")}, {"attributes": ("",)}):
        with pytest.raises(ValueError):
            st.SIVFConfig(dim=16, n_lists=4, n_slabs=8, **kw)
    full = st.SIVFConfig(dim=16, n_lists=4, n_slabs=8,
                         pq=st.PQConfig(m=4, nbits=5),
                         attributes=["tenant", "ts"])
    assert full.attributes == ("tenant", "ts")
    assert interop.config_from_dict(interop.config_to_dict(full)) == full
    jfull = jcore.SIVFConfig(**{**interop.config_to_dict(full),
                                "dtype": jnp.float32,
                                "pq": jcore.PQConfig(m=4, nbits=5)})
    assert (full.payload_dim, full.code_m, full.n_attrs) == \
        (jfull.payload_dim, jfull.code_m, jfull.n_attrs) == (0, 4, 2)


@pytest.mark.parametrize("capacity", [32, 64, 128])
def test_memory_report_matches_reference(capacity):
    kw = dict(dim=24, n_lists=7, n_slabs=33, capacity=capacity, n_max=999)
    assert st.memory_report(st.SIVFConfig(**kw)) == \
        jcore.memory_report(jcore.SIVFConfig(**kw))


def test_bitmap_unpack_and_bits_match_reference(rng):
    words = rng.integers(0, 1 << 32, size=(6, 4), dtype=np.uint64
                         ).astype(np.uint32)
    words[0, 0] = np.uint32(1 << 31)
    tw = torch.from_numpy(words.view(np.int32))
    ref = np.asarray(jbm.unpack_batch(jnp.asarray(words), 128))
    assert np.array_equal(bm.unpack_batch(tw, 128).numpy(), ref)
    assert np.array_equal(bm.unpack(tw[2], 128).numpy(), ref[2])
    assert np.array_equal(bm.popcount_rows(tw).numpy(),
                          np.asarray(jbm.popcount_rows(jnp.asarray(words))))
    slots = np.arange(128, dtype=np.int32)
    jw, jb = jbm.slot_word_bit(jnp.asarray(slots))
    tw_, tb = bm.slot_word_bit(torch.from_numpy(slots))
    assert np.array_equal(tw_.numpy(), np.asarray(jw))
    assert np.array_equal(tb.numpy().view(np.uint32), np.asarray(jb))
    slab = rng.integers(0, 6, 50).astype(np.int32)
    slot = rng.integers(0, 128, 50).astype(np.int32)
    assert np.array_equal(
        bm.get_bits(tw, torch.from_numpy(slab), torch.from_numpy(slot))
        .numpy(),
        np.asarray(jbm.get_bits(jnp.asarray(words), jnp.asarray(slab),
                                jnp.asarray(slot))))
    with pytest.raises(ValueError):
        bm.n_words(40)


def test_host_live_mask_accepts_both_word_types(rng):
    cfg = st.SIVFConfig(dim=4, n_lists=2, n_slabs=3, capacity=64)
    words = rng.integers(0, 1 << 32, size=(3, 2), dtype=np.uint64
                         ).astype(np.uint32)
    ref = jcore.state.host_live_mask(jcore.SIVFConfig(
        dim=4, n_lists=2, n_slabs=3, capacity=64), words)
    assert np.array_equal(st.host_live_mask(cfg, words), ref)
    assert np.array_equal(
        st.host_live_mask(cfg, torch.from_numpy(words.view(np.int32))), ref)


def test_utils_match_reference(rng):
    x = rng.integers(0, 9, 17).astype(np.int32)
    assert np.array_equal(
        utils.exclusive_cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jutils.exclusive_cumsum(jnp.asarray(x))))
    assert utils.ceil_div(7, 3) == jutils.ceil_div(7, 3) == 3
    assert utils.round_up(10, 4) == jutils.round_up(10, 4) == 12
    a = rng.normal(size=(9, 12)).astype(np.float32)
    b = rng.normal(size=(5, 12)).astype(np.float32)
    np.testing.assert_allclose(
        utils.l2_sq(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jutils.l2_sq(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
