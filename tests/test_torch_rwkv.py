"""The port's RWKV6 serving slice against the JAX reference, on the CPU.

``rwkv6-3b.reduced()`` (float32: 2 layers, d_model 64, 4 heads of 16).
Parameters are made with numpy from a seed in the reference's stripped
param-tree layout (:func:`numpy_tree`) and carried across by
``interop.params_from_numpy``; every other input is numpy too. What each
comparison holds, and why:

  * the plain WKV6 recurrence ``wkv6_ref`` against the reference's oracle
    ``kernels/wkv6/ref.py::wkv6_ref`` (``lax.scan`` over all of T, zero
    state) at ragged T = 1, 7, 517, and against its
    ``_wkv_sequential`` (the ``impl="xla"`` path, chunked) from a
    non-zero state at T it runs: ``y`` and the final state within 1e-5
    relative to their RMS (float32 sums of 16 terms in another order);
  * a split sequence, (0..t) then (t..T) from the carried state, equals
    the whole bit for bit (the same operations in the same order);
  * ``time_mix`` (the padded-head mask included), ``channel_mix`` and
    ``forward(collect_cache=True)`` against the reference's functions
    with ``impl="xla"``: within 1e-5;
  * ``PagedLMEngine`` against the reference's
    ``PagedLMEngine(attn_impl="pallas_interpret")`` (whose recurrences
    run ``impl="xla"``) through admit / step / slide / evict / re-admit
    at prompt lengths its chunked recurrence runs (13 and 21): page state
    ``==`` after every operation, logits and recurrent states within 1e-4
    (float32 through two layers and eight steps);
  * the port alone at a ragged prompt (37 tokens, which the reference's
    chunked recurrence cannot reshape): a prefill of 30 tokens and seven
    teacher-forced steps give the 37-token prefill's last logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels.wkv6.ref import wkv6_ref as jwkv6_ref
from repro.models import model as JM
from repro.models import rwkv as jrwkv
from repro.serve.paged_lm import PagedLMEngine as JEngine
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.kernels.wkv6 import ops
from repro_torch.kernels.wkv6 import wkv6 as kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_split_ref
from repro_torch.models import model as M
from repro_torch.models import rwkv
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding import rules

TOL, ENGINE_TOL = 1e-5, 1e-4
JCFG = JARCHS["rwkv6-3b"].reduced()
CFG = get_arch("rwkv6-3b").reduced()
JPLAN, PLAN = jrules.unpadded_plan(JCFG), rules.unpadded_plan(CFG)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got: torch.Tensor, want, tol: float = TOL, what: str = "") -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def close_rms(got: torch.Tensor, want, tol: float = TOL,
              what: str = "") -> None:
    """Within ``tol`` of the reference's RMS, entry by entry: for values
    summed from many terms, where an entry near 0 carries the rounding of
    terms of the typical size."""
    want = np.asarray(want, np.float32)
    scale = float(np.sqrt(np.mean(want ** 2))) or 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def numpy_tree(jcfg, jplan, seed: int) -> dict:
    """A random param tree with numpy leaves in the reference's stripped
    layout (its shapes from ``jax.eval_shape`` of its ``init_params``):
    matrices ``N(0, 1/fan_in)``, norm scales and biases away from 1 and 0
    so that they count, and each recurrent parameter in its model's range
    (RWKV's ``mu`` in [0,1), decay base ``w0`` about -0.6, bonus ``u``;
    Mamba's ``a_log``, ``dt_bias``, ``d``)."""
    rng = np.random.default_rng(seed)
    shapes = strip(jax.eval_shape(lambda k: JM.init_params(jcfg, jplan, k),
                                  jax.random.key(0)))

    def fill(path, leaf):
        name, shp = path[-1].key, leaf.shape
        if name in ("scale", "ln_scale"):
            a = 1 + 0.2 * rng.normal(size=shp)
        elif name in ("bias", "ln_bias", "conv_b"):
            a = 0.1 * rng.normal(size=shp)
        elif name == "mu":
            a = rng.uniform(size=shp)
        elif name == "w0":
            a = -0.6 + 0.5 * rng.normal(size=shp)
        elif name == "u":
            a = 0.1 * rng.normal(size=shp)
        elif name == "a_log":
            a = np.log(rng.uniform(0.5, 16, size=shp))
        elif name == "dt_bias":
            a = np.log(np.expm1(rng.uniform(1e-3, 1e-1, size=shp)))
        elif name == "d":
            a = 1 + 0.1 * rng.normal(size=shp)
        elif name == "table":
            a = 0.02 * rng.normal(size=shp)
        else:
            a = rng.normal(size=shp) / np.sqrt(shp[-2])
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jtree(tree) -> dict:
    return jax.tree.map(jnp.asarray, tree)


def wkv_inputs(rng, b, steps, h, dk, dv, state: bool):
    f = np.float32
    r, k = (rng.normal(size=(b, steps, h, dk)).astype(f) for _ in "rk")
    v = rng.normal(size=(b, steps, h, dv)).astype(f)
    w = np.exp(-np.exp(rng.normal(-0.6, 1, size=(b, steps, h, dk)))
               ).astype(f)
    u = (0.1 * rng.normal(size=(h, dk))).astype(f)
    s0 = rng.normal(size=(b, h, dk, dv)).astype(f) if state else \
        np.zeros((b, h, dk, dv), f)
    return r, k, v, w, u, s0


jwkv_sequential = jax.jit(jrwkv._wkv_sequential, static_argnums=6)
jtime_mix = jax.jit(jrwkv.time_mix, static_argnums=(1, 2),
                    static_argnames=("impl", "chunk"))
jchannel_mix = jax.jit(jrwkv.channel_mix, static_argnums=1)
jforward = jax.jit(JM.forward, static_argnums=(1, 2),
                   static_argnames=("collect_cache",))


# ---------------------------------------------------------------------------
# the plain WKV6 recurrence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 7, 517])
def test_wkv6_plain_matches_the_reference_oracle_at_ragged_lengths(steps):
    rng = np.random.default_rng(steps)
    r, k, v, w, u, _ = wkv_inputs(rng, 2, steps, 3, 16, 16, state=False)
    y, s = wkv6_ref(*(t(a) for a in (r, k, v, w, u)))
    assert y.shape == (2, steps, 3, 16) and s.shape == (2, 3, 16, 16)
    close_rms(y, jwkv6_ref(*(jnp.asarray(a) for a in (r, k, v, w, u))))


@pytest.mark.parametrize("steps,dk,dv", [(16, 16, 16), (32, 16, 8),
                                         (48, 8, 16)])
def test_wkv6_plain_matches_the_sequential_path_from_a_state(steps, dk, dv):
    """Against ``_wkv_sequential`` (chunk 16) from a non-zero state: the
    output and the final state."""
    rng = np.random.default_rng(100 + steps)
    args = wkv_inputs(rng, 2, steps, 3, dk, dv, state=True)
    jy, js = jwkv_sequential(*(jnp.asarray(a) for a in args), 16)
    y, s = wkv6_ref(*(t(a) for a in args))
    close_rms(y, jy, what="y")
    close_rms(s, js, what="final state")


def test_wkv6_split_sequence_equals_the_whole():
    rng = np.random.default_rng(7)
    r, k, v, w, u, s0 = (t(a) for a in wkv_inputs(rng, 2, 29, 2, 16, 16,
                                                  state=True))
    y, s = ops.wkv6(r, k, v, w, u, s0)
    for cut in (1, 13, 28):
        y1, s1 = ops.wkv6(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                          u, s0)
        y2, s2 = ops.wkv6(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                          u, s1)
        assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, s)
    assert kernel.launches == 0           # the CPU takes the plain version


def test_wkv6_operands_are_checked():
    rng = np.random.default_rng(8)
    r, k, v, w, u, s0 = (t(a) for a in wkv_inputs(rng, 1, 3, 2, 16, 8,
                                                  state=True))
    with pytest.raises(ValueError, match="float32"):
        wkv6_ref(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="s0"):
        wkv6_ref(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="T>=1"):
        wkv6_ref(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    with pytest.raises(ValueError, match="CUDA"):   # the real wrapper
        kernel.wkv6_cuda(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# the CUDA kernel's own arithmetic and launch plan, in plain PyTorch
# ---------------------------------------------------------------------------

def wkv_edge_inputs(rng, b, steps, h, dk, dv, w_kind: str, state: bool):
    """:func:`wkv_inputs` with the decay near 0 (1e-3..1e-2), near 1
    (1 - 1e-4..1e-3) or of the model's form."""
    r, k, v, w, u, s0 = wkv_inputs(rng, b, steps, h, dk, dv, state)
    if w_kind == "near0":
        w = rng.uniform(1e-3, 1e-2, size=w.shape).astype(np.float32)
    elif w_kind == "near1":
        w = (1 - rng.uniform(1e-4, 1e-3, size=w.shape)).astype(np.float32)
    return r, k, v, w, u, s0


SPLIT_CASES = [  # steps, dk, dv, decay: ragged T about the 32-step chunk,
    (1, 16, 16, "model"),          # dv off the 32-column group
    (31, 64, 40, "near0"),
    (32, 64, 64, "near1"),
    (33, 16, 40, "model"),
    (33, 128, 32, "near0"),
    (31, 128, 72, "near1"),
    (517, 64, 40, "model"),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: "T{}-dk{}-dv{}-{}".format(*c))
def test_wkv6_split_order_matches_the_oracle_and_the_plain_version(case):
    """``wkv6_split_ref`` (the kernel's row slices of ``ROWS``, column
    groups of ``COLS``, the bonus factored as ``beta_t v``, y summed slice
    by slice per chunk) against the reference's oracle from a zero state
    and against ``wkv6_ref`` from a non-zero one."""
    steps, dk, dv, w_kind = case
    rng = np.random.default_rng(300 + steps + dk)
    plan = kernel.launch_plan(*(torch.empty(a.shape, device="meta")
                                for a in wkv_inputs(rng, 2, steps, 3, dk, dv,
                                                    False)))
    kw = dict(rows=plan["rows"], cols=plan["cols"], chunk=plan["chunk"])
    args = wkv_edge_inputs(rng, 2, steps, 3, dk, dv, w_kind, state=False)
    y, s = wkv6_split_ref(*(t(a) for a in args), **kw)
    close_rms(y, jwkv6_ref(*(jnp.asarray(a) for a in args[:5])), what="y")
    args = wkv_edge_inputs(rng, 2, steps, 3, dk, dv, w_kind, state=True)
    want = wkv6_ref(*(t(a) for a in args))
    got = wkv6_split_ref(*(t(a) for a in args), **kw)
    close_rms(got[0], want[0], what="y from a state")
    close_rms(got[1], want[1], what="final state")


def test_wkv6_launch_plan_reads_shapes_only():
    """The launch plan is a function of shapes: meta tensors, which hold
    no values, will do."""
    def meta(b, steps, h, dk, dv):
        return [torch.empty(shape, device="meta") for shape in (
            (b, steps, h, dk), (b, steps, h, dk), (b, steps, h, dv),
            (b, steps, h, dk), (h, dk), (b, h, dk, dv))]
    admit = kernel.launch_plan(*meta(1, 2048, 40, 64, 64))   # RWKV6-3B
    assert (admit["blocks"], admit["threads"], admit["chunk"]) == (80, 128, 32)
    assert admit["col_groups"] == 2 and admit["vec"]
    assert not admit["decode_instance"]
    assert admit["smem_bytes"] == kernel.smem_bytes(64, 32)
    decode = kernel.launch_plan(*meta(8, 1, 40, 64, 64))
    assert (decode["blocks"], decode["chunk"]) == (640, 1)
    assert decode["decode_instance"]
    wide = kernel.launch_plan(*meta(1, 517, 3, 128, 40))     # dk = 128
    assert wide["chunk"] == 16 and wide["threads"] == 256
    assert wide["smem_bytes"] <= kernel.SMEM_LIMIT < kernel.smem_bytes(128,
                                                                       32)
    assert wide["col_groups"] == 2                  # 40 columns: 32 + 8
    assert kernel.launch_plan(*meta(2, 7, 3, 16, 30))["chunk"] == 8
    assert not kernel.launch_plan(*meta(2, 7, 3, 16, 30))["vec"]
    with pytest.raises(ValueError, match="dk=48"):
        kernel.launch_plan(*meta(1, 4, 2, 48, 48))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    return numpy_tree(JCFG, JPLAN, 0)


@pytest.fixture(scope="module")
def port_params(tree):
    return interop.params_from_numpy(CFG, tree, device="cpu")


@pytest.mark.parametrize("seq,state", [(1, True), (13, False), (13, True)])
def test_time_mix_matches_the_reference(tree, port_params, seq, state):
    rng = np.random.default_rng(10 + seq)
    p = {k: a[1] for k, a in tree["layers"][0]["tm"].items()}
    x = rng.normal(size=(2, seq, CFG.d_model)).astype(np.float32)
    hs, h = CFG.rwkv_head_size, PLAN.n_heads_padded
    xp = rng.normal(size=(2, 1, CFG.d_model)).astype(np.float32) * state
    s0 = rng.normal(size=(2, h, hs, hs)).astype(np.float32) * state
    jo, (jx, js) = jtime_mix(jtree(p), JCFG, JPLAN, jnp.asarray(x),
                             (jnp.asarray(xp), jnp.asarray(s0)), impl="xla")
    for impl in ("kernel", "ref"):
        o, (nx, ns) = rwkv.time_mix(port_params.layers[1]["tm"], CFG, PLAN,
                                    t(x), (t(xp), t(s0)), impl=impl)
        close(o, jo, what="out")
        close(nx, jx, what="x_prev")
        close_rms(ns, js, what="S")


def test_time_mix_masks_padded_heads():
    """A plan with 6 heads for 4 real ones: the padded heads' output is
    masked before the projection, as the reference masks it."""
    jplan = dataclasses.replace(JPLAN, n_heads_padded=6)
    plan = dataclasses.replace(PLAN, n_heads_padded=6)
    tree = numpy_tree(JCFG, jplan, 3)
    p = {k: a[0] for k, a in tree["layers"][0]["tm"].items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 5, CFG.d_model)).astype(np.float32)
    st = (np.zeros((1, 1, CFG.d_model), np.float32),
          np.zeros((1, 6, 16, 16), np.float32))
    jo, _ = jtime_mix(jtree(p), JCFG, jplan, jnp.asarray(x),
                      tuple(jnp.asarray(a) for a in st), impl="xla")
    tp = interop.params_from_numpy(CFG, tree, device="cpu")
    o, _ = rwkv.time_mix(tp.layers[0]["tm"], CFG, plan, t(x),
                         tuple(t(a) for a in st))
    close(o, jo)
    w_o = tp.layers[0]["tm"]["w_o"].clone()
    w_o[64:] = 1e3                       # rows of the two padded heads
    tp.layers[0]["tm"]["w_o"].copy_(w_o)
    o2, _ = rwkv.time_mix(tp.layers[0]["tm"], CFG, plan, t(x),
                          tuple(t(a) for a in st))
    assert torch.equal(o, o2)


def test_channel_mix_matches_the_reference(tree, port_params):
    rng = np.random.default_rng(12)
    p = {k: a[0] for k, a in tree["layers"][0]["cm"].items()}
    x = rng.normal(size=(2, 9, CFG.d_model)).astype(np.float32)
    xp = rng.normal(size=(2, 1, CFG.d_model)).astype(np.float32)
    jo, jx = jchannel_mix(jtree(p), JCFG, jnp.asarray(x), jnp.asarray(xp))
    o, nx = rwkv.channel_mix(port_params.layers[0]["cm"], CFG, t(x), t(xp))
    close(o, jo)
    close(nx, jx)


def test_forward_logits_and_caches_match_the_reference(tree, port_params):
    toks = np.random.default_rng(5).integers(1, CFG.vocab_size,
                                             (2, 21)).astype(np.int32)
    jl, jaux, jc = jforward(jtree(tree), JCFG, JPLAN,
                            {"tokens": jnp.asarray(toks)}, collect_cache=True)
    logits, aux, caches = M.forward(port_params, CFG, PLAN,
                                    {"tokens": t(toks)}, collect_cache=True)
    close(logits, jl)
    assert float(aux) == float(jaux) == 0.0
    assert M.kinds_present(CFG) == ["rwkv"] and len(caches) == len(jc) == 1
    for got, want, what in zip(caches[0], jc[0], ("x_tm", "S", "x_cm")):
        assert got.shape == want.shape, what     # [n_layers, B, ...]
        close_rms(got, want, what=what)
    ref, _, none = M.forward(port_params, CFG, PLAN, {"tokens": t(toks)},
                             impl="ref")
    assert none is None and torch.equal(ref, logits)


def test_init_params_matches_the_reference_tree_and_keeps_float32_leaves():
    small = dataclasses.replace(CFG, dtype="bfloat16")
    a = M.init_params(small, PLAN, seed=3, device="cpu")
    b = M.init_params(small, PLAN, seed=3, device="cpu")
    assert torch.equal(a.layers[1]["tm"]["w_k"], b.layers[1]["tm"]["w_k"])
    tm = a.layers[0]["tm"]
    assert tm["w_r"].dtype == torch.bfloat16
    assert {k for k, v in tm.items() if v.dtype == torch.float32} == \
        set(rwkv.FLOAT32_LEAVES)
    assert a.layers[0]["cm"]["w_v"].dtype == torch.bfloat16
    shapes = jax.tree.map(lambda x: x.shape,
                          interop.params_to_numpy(small, a))
    ref = jax.tree.map(lambda x: x.shape, strip(jax.eval_shape(
        lambda k: JM.init_params(JCFG, JPLAN, k), jax.random.key(0))))
    assert shapes == ref


def test_params_and_states_cross_both_ways_unchanged(tree, port_params):
    back = interop.params_to_numpy(CFG, port_params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and bool((a == b).all()), tree,
        back)))
    bf = interop.params_from_numpy(CFG, tree, device="cpu",
                                   dtype=torch.bfloat16)
    assert bf.layers[0]["tm"]["u"].dtype == torch.float32
    assert bf.layers[0]["tm"]["w_g"].dtype == torch.bfloat16
    eng = PagedLMEngine(CFG, PLAN, port_params, device="cpu", **ENGINE)
    rng = np.random.default_rng(9)
    for pool in eng.state["rwkv"]:
        pool.copy_(t(rng.normal(size=pool.shape).astype(np.float32)))
    entries = interop.recurrent_state_to_numpy(CFG, eng.state)
    assert [tuple(a.shape) for a in entries[0]] == [
        (2, 3, 1, 64), (2, 3, 4, 16, 16), (2, 3, 1, 64)]
    again = interop.recurrent_state_from_numpy(CFG, entries, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again["rwkv"],
                                                  eng.state["rwkv"]))


# ---------------------------------------------------------------------------
# the slice as a whole: the engine against the reference's
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=8, n_pages=24, max_seqs=3, max_pages_per_seq=8)


def serve_both(jcfg, jplan, cfg, plan, tree, port_params, seed,
               prefix=None):
    """Both engines through one traffic: admit 13 and 21 tokens, five
    teacher-forced steps, slide, evict, a re-admit of 13 tokens into the
    freed slot, three steps. ``prefix`` ([n_img, d], for the vision stub)
    goes with the first admit. Per operation: page state, the K/V pools,
    recurrent states, step logits and next tokens of each."""
    rng = np.random.default_rng(seed)
    jeng = JEngine(jcfg, jplan, jtree(tree), attn_impl="pallas_interpret",
                   **ENGINE)
    teng = PagedLMEngine(cfg, plan, port_params, device="cpu", **ENGINE)
    jlogits, jdecode = [], jeng._decode

    def capture(*args):                 # the reference step's logits
        out = jdecode(*args)
        jlogits.append(out[0])
        return out

    jeng._decode = capture
    log = []

    def record(op, jout=None, tout=None):
        log.append(dict(
            op=op, jpages={n: np.asarray(getattr(jeng.pages, n))
                           for n in interop.kvc.PLANES},
            tpages=interop.page_state_to_numpy(teng.pages),
            jstate=[None if e is None or cfg.is_attn_layer(pos) else
                    tuple(np.asarray(a) for a in e)
                    for pos, e in enumerate(jeng.pools)],
            tstate=interop.recurrent_state_to_numpy(cfg, teng.state),
            jkv=[tuple(np.asarray(a) for a in e) if cfg.is_attn_layer(pos)
                 else None for pos, e in enumerate(jeng.pools)],
            tkv=interop.kv_pools_to_numpy(cfg, teng.k_pool, teng.v_pool),
            jout=jout, tout=tout))

    def step(forced: bool):
        if forced:
            for seq in np.nonzero(np.asarray(jeng.pages.active))[0]:
                tok = int(rng.integers(1, cfg.vocab_size))
                jeng.last_tokens = jeng.last_tokens.at[seq, 0].set(tok)
                teng.last_tokens[seq, 0] = tok
        jn, tn = jeng.step(), teng.step()
        record("step", (np.asarray(jlogits[-1]), jn),
               (teng.logits.numpy().copy(), tn))

    for seq, n in ((0, 13), (1, 21)):
        prompt = rng.integers(1, cfg.vocab_size, n)
        pre = prefix if seq == 0 else None
        record(f"admit{seq}", jeng.admit(seq, prompt, prefix_embeds=pre),
               teng.admit(seq, prompt, prefix_embeds=pre))
    for _ in range(5):
        step(forced=True)
    jeng.slide(0, keep_last=8)
    teng.slide(0, keep_last=8)
    record("slide")
    jeng.evict(1)
    teng.evict(1)
    record("evict")
    prompt = rng.integers(1, cfg.vocab_size, 13)
    record("readmit1", jeng.admit(1, prompt), teng.admit(1, prompt))
    for _ in range(3):
        step(forced=False)
    return log


def check_served(log, cfg) -> None:
    """Page state ``==`` after every operation; K/V pools, recurrent
    states and step logits within ENGINE_TOL, next tokens ``==``."""
    assert [e["op"] for e in log] == ["admit0", "admit1"] + ["step"] * 5 + \
        ["slide", "evict", "readmit1"] + ["step"] * 3
    for i, e in enumerate(log):
        what = f"{i} {e['op']}"
        for name, a in e["tpages"].items():
            np.testing.assert_array_equal(a, e["jpages"][name],
                                          err_msg=f"{what}: {name}")
        for key in ("state", "kv"):
            for pos, (te, je) in enumerate(zip(e["t" + key], e["j" + key])):
                assert (te is None) == (je is None), (what, key, pos)
                for j, (a, b) in enumerate(zip(te or (), je or ())):
                    assert a.shape == b.shape, (what, key, pos, j)
                    close_rms(t(a), b, ENGINE_TOL,
                              f"{what}: {key} pos {pos} pool {j}")
        if e["op"] == "step":
            (jl, jn), (tl, tn) = e["jout"], e["tout"]
            assert tl.shape == jl.shape == (ENGINE["max_seqs"], 1,
                                            cfg.vocab_size)
            np.testing.assert_allclose(tl, jl, rtol=ENGINE_TOL,
                                       atol=ENGINE_TOL, err_msg=what)
            np.testing.assert_array_equal(tn, jn, err_msg=what)
        elif e["op"].startswith(("admit", "readmit")):
            assert e["jout"] is True and e["tout"] is True


@pytest.fixture(scope="module")
def served(tree, port_params):
    kernel.launches = 0
    return serve_both(JCFG, JPLAN, CFG, PLAN, tree, port_params, seed=6)


def test_engine_matches_the_reference_after_each_operation(served):
    check_served(served, CFG)
    free = [int(e["tpages"]["free_top"]) for e in served]
    assert free[7] > free[6] and free[8] > free[7]   # slide, evict freed
    assert kernel.launches == 0                       # CPU: plain version


def test_engine_continues_a_ragged_prompt_from_its_carried_state(
        port_params):
    """37 tokens at once, and 30 then seven teacher-forced steps, leave
    the same last logits and states: decode carries what prefill left."""
    prompt = np.random.default_rng(11).integers(1, CFG.vocab_size, 37)
    whole = PagedLMEngine(CFG, PLAN, port_params, device="cpu", **ENGINE)
    assert whole.admit(0, prompt)
    with torch.no_grad():
        want, _, _ = M.forward(port_params, CFG, PLAN,
                               {"tokens": t(prompt[None].astype(np.int32))})
    part = PagedLMEngine(CFG, PLAN, port_params, device="cpu", **ENGINE)
    assert part.admit(0, prompt[:30])
    for tok in prompt[30:]:
        part.last_tokens[0, 0] = int(tok)
        part.step()
    close(part.logits[0, 0], want[0, -1], ENGINE_TOL)
    for a, b in zip(part.state["rwkv"], whole.state["rwkv"]):
        close_rms(a[:, 0], b[:, 0], ENGINE_TOL)
