"""The port's LM serving slice against the JAX reference, on the CPU.

Configs, the single-device plan, the model blocks, the paged KV cache and
``PagedLMEngine`` at ``llama3-8b.reduced()`` (float32). Parameters are
made with numpy from a seed in the reference's stripped param-tree layout
and carried across by ``interop.params_from_numpy``; prompts and the
teacher-forced tokens are numpy too. What each comparison holds:

  * configs and plans: field for field ``==``;
  * ``apply_norm``, ``rms_norm_1d``, ``apply_rope``, ``embed_lookup``,
    ``lm_head``, ``apply_mlp`` and ``forward(collect_cache=True)``
    (logits and caches): within 1e-5 (the sums run in another order);
  * page state after ``allocate`` / ``evict_seq`` / ``slide_window``,
    exhaustion included: every plane ``==``;
  * the engine against the reference's
    ``PagedLMEngine(attn_impl="pallas_interpret")`` (its paged kernel in
    interpret mode; its prefill runs ``impl="xla"``): admit two prompts
    whose lengths are not page multiples, five teacher-forced steps,
    ``slide``, ``evict``, a re-admit into the freed slot, three more
    steps. Logits within 1e-4 at each step, next tokens ``==`` and page
    state ``==`` after each operation. One module-scoped run of both
    engines serves every engine test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as JM
from repro.serve import kv_cache as jkvc
from repro.serve.paged_lm import PagedLMEngine as JEngine
from repro.sharding import rules as jrules
from repro.sharding.axes import strip
from repro_torch import interop
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import flash_attention as fkernel
from repro_torch.kernels.paged_attention import paged_attention as pkernel
from repro_torch.models import common, mlp
from repro_torch.models import model as M
from repro_torch.serve import kv_cache as kvc
from repro_torch.serve.paged_lm import PagedLMEngine
from repro_torch.sharding import rules

TOL, ENGINE_TOL = 1e-5, 1e-4
JCFG = JARCHS["llama3-8b"].reduced()
CFG = get_arch("llama3-8b").reduced()
JPLAN, PLAN = jrules.unpadded_plan(JCFG), rules.unpadded_plan(CFG)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def numpy_tree(cfg, seed: int, n_per: int | None = None) -> dict:
    """A random param tree in the reference's stripped layout (one period
    position, leaves stacked ``[n_per, ...]``), with norm scales away from
    1 so that they count."""
    rng = np.random.default_rng(seed)
    n = cfg.n_layers if n_per is None else n_per
    d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    def scale(*shape):
        return (1 + 0.2 * rng.normal(size=shape)).astype(np.float32)

    table = (0.02 * rng.normal(size=(cfg.vocab_size, d))).astype(np.float32)
    layer = {"ln1": {"scale": scale(n, d)},
             "attn": {"wq": w(n, d, hq * dh), "wk": w(n, d, hkv * dh),
                      "wv": w(n, d, hkv * dh), "wo": w(n, hq * dh, d)},
             "ln2": {"scale": scale(n, d)},
             "mlp": {"w_up": w(n, d, f), "w_down": w(n, f, d),
                     "w_gate": w(n, d, f)}}
    return {"embed": {"table": table}, "final_norm": {"scale": scale(d)},
            "layers": [layer],
            "head": {"table": (0.02 * rng.normal(size=(
                cfg.vocab_size, d))).astype(np.float32)}}


def jtree(tree: dict) -> dict:
    return jax.tree.map(jnp.asarray, tree)


# the reference's functions, jitted: one compile per shape instead of one
# per operation (``apply_rope`` stays eager: under ``jit`` XLA's float32
# sin/cos of angles near 1e4..7e4 radians differ from its eager ones by
# about 4e-5)
japply_norm = jax.jit(jcommon.apply_norm)
jrms_norm_1d = jax.jit(jcommon.rms_norm_1d)
jembed_lookup = jax.jit(jcommon.embed_lookup, static_argnums=2)
jlm_head = jax.jit(jcommon.lm_head, static_argnums=2)
japply_mlp = jax.jit(jmlp.apply_mlp, static_argnums=2)
jforward = jax.jit(JM.forward, static_argnums=(1, 2),
                   static_argnames=("collect_cache",))


# ---------------------------------------------------------------------------
# configs and the single-device plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(JARCHS))
def test_registry_runs_llama_and_names_the_roadmap_for_the_rest(name):
    """Every architecture of the reference's registry is ported (Whisper
    last): each config equals the reference's, full and reduced."""
    assert name in ARCHS
    for port, ref in ((get_arch(name), JARCHS[name]),
                      (get_arch(name).reduced(), JARCHS[name].reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.layer_period == ref.layer_period
        assert [port.is_attn_layer(i) for i in range(4)] == \
            [ref.is_attn_layer(i) for i in range(4)]


def test_llama_config_and_plan_match_the_reference():
    full = get_arch("llama3-8b")
    assert full.param_count() == 8_030_261_248
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.dtype) == \
        (32, 4096, 32, 8, 128, 14336, 128256, "bfloat16")
    for cfg, jcfg in ((full, JARCHS["llama3-8b"]), (CFG, JCFG)):
        assert dataclasses.asdict(rules.make_plan(cfg, None)) == \
            dataclasses.asdict(jrules.make_plan(jcfg, None))
    assert rules.unpadded_plan(full).group_size == 4
    assert dataclasses.asdict(rules.make_plan(CFG, {"data": 4, "model": 1})) \
        == dataclasses.asdict(jrules.make_plan(JCFG, {"data": 4, "model": 1}))
    with pytest.raises(KeyError):
        get_arch("llama3-70b")
    for kind in ("train", "prefill", "decode"):    # the mesh plan (10b)
        assert dataclasses.asdict(rules.make_plan(
            CFG, {"data": 2, "model": 2}, kind)) == dataclasses.asdict(
            jrules.make_plan(JCFG, {"data": 2, "model": 2}, kind))


# ---------------------------------------------------------------------------
# (b) model blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_and_qk_norm(kind):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": (1 + 0.3 * rng.normal(size=64)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    tp = common.param_group(**{k: t(v) for k, v in p.items()})
    close(common.apply_norm(tp, t(x)), japply_norm(jtree(p),
                                                          jnp.asarray(x)))
    got = common.apply_norm(tp, t(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    close(common.rms_norm_1d(t(x), t(p["scale"])),
          jrms_norm_1d(jnp.asarray(x), jnp.asarray(p["scale"])))


def test_apply_rope_prefill_and_decode_positions():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(7) + 1000
    close(common.apply_rope(t(x), t(pos), 500000.0),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    xd = x[:, :1]                                   # decode: [B,1,H,dh]
    posd = np.array([[3], [70000]], np.int32)        # per-row positions
    close(common.apply_rope(t(xd), t(posd), 10000.0),
          jcommon.apply_rope(jnp.asarray(xd), jnp.asarray(posd), 10000.0))


def test_embed_lookup_and_lm_head_mask_padded_vocab():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    tok = rng.integers(0, 40, (2, 5)).astype(np.int32)
    p = {"table": table}
    tp = common.param_group(table=t(table))
    close(common.embed_lookup(tp, t(tok), torch.float32),
          jembed_lookup(jtree(p), jnp.asarray(tok), jnp.float32))
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    for vocab in (40, 33):                  # 33: rows 33..39 are padding
        got = common.lm_head(tp, t(x), vocab)
        close(got, jlm_head(jtree(p), jnp.asarray(x), vocab))
    assert (got[..., 33:] == -1e30).all()


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_apply_mlp(act):
    rng = np.random.default_rng(4)
    p = {"w_up": rng.normal(size=(16, 48)).astype(np.float32) / 4,
         "w_down": rng.normal(size=(48, 16)).astype(np.float32) / 7}
    if act == "swiglu":
        p["w_gate"] = rng.normal(size=(16, 48)).astype(np.float32) / 4
    x = rng.normal(size=(3, 2, 16)).astype(np.float32)
    tp = common.param_group(**{k: t(v) for k, v in p.items()})
    close(mlp.apply_mlp(tp, t(x), act),
          japply_mlp(jtree(p), jnp.asarray(x), act))


@pytest.fixture(scope="module")
def tree():
    return numpy_tree(CFG, 0)


@pytest.fixture(scope="module")
def port_params(tree):
    return interop.params_from_numpy(CFG, tree, device="cpu")


def test_params_cross_both_ways_unchanged(tree, port_params):
    back = interop.params_to_numpy(CFG, port_params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(
        lambda a, b: a.dtype == b.dtype and bool((a == b).all()), tree,
        back)))
    bf = interop.params_from_numpy(CFG, tree, device="cpu",
                                   dtype=torch.bfloat16)
    assert bf.layers[1]["attn"]["wq"].dtype == torch.bfloat16
    assert bf.layers[1]["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(bf.layers[1]["attn"]["wq"].float(),
                       t(tree["layers"][0]["attn"]["wq"][1]).to(
                           torch.bfloat16).float())


def test_forward_logits_and_caches_match_the_reference(tree, port_params):
    toks = np.random.default_rng(5).integers(1, CFG.vocab_size,
                                             (2, 21)).astype(np.int32)
    jl, _, jc = jforward(jtree(tree), JCFG, JPLAN,
                           {"tokens": jnp.asarray(toks)}, collect_cache=True)
    logits, aux, caches = M.forward(port_params, CFG, PLAN,
                                    {"tokens": t(toks)}, collect_cache=True)
    assert float(aux) == 0.0
    close(logits, jl)
    assert len(caches) == len(jc) == 1
    for got, want in zip(caches[0], jc[0]):     # [n_layers, B, S, Hkv, dh]
        assert got.shape == want.shape
        close(got, want)
    ref, _, none = M.forward(port_params, CFG, PLAN, {"tokens": t(toks)},
                             impl="ref")
    assert none is None and torch.equal(ref, logits)


def test_init_params_is_seeded_and_stores_the_config_dtype():
    small = dataclasses.replace(CFG, dtype="bfloat16")
    a = M.init_params(small, PLAN, seed=3, device="cpu")
    b = M.init_params(small, PLAN, seed=3, device="cpu")
    c = M.init_params(small, PLAN, seed=4, device="cpu")
    assert torch.equal(a.layers[1]["mlp"]["w_down"],
                       b.layers[1]["mlp"]["w_down"])
    assert not torch.equal(a.embed["table"], c.embed["table"])
    assert a.embed["table"].dtype == torch.bfloat16
    assert a.layers[0]["ln2"]["scale"].dtype == torch.float32
    shapes = jax.tree.map(lambda x: x.shape,
                          interop.params_to_numpy(small, a))
    ref = jax.tree.map(lambda x: x.shape, strip(jax.eval_shape(
        lambda k: JM.init_params(JCFG, JPLAN, k), jax.random.key(0))))
    assert shapes == ref
    assert sum(p.numel() for p in a.parameters()) == CFG.param_count()


@pytest.mark.parametrize("change,item", [
    (dict(attention="mla"), "queue 1 item 13"),
    (dict(moe=True, n_experts=4, moe_top_k=2, n_shared_experts=1),
     "queue 1 item 13"),
    (dict(enc_dec=True, n_enc_layers=1, enc_seq=8, frontend="audio_stub"),
     "queue 1 item 13"),
    (dict(frontend="vision_stub"), "queue 1 item 13"),
])
def test_unported_blocks_raise_naming_their_roadmap_item(change, item):
    """Every block of queue 1 item 13 is ported: MLA, shared experts, the
    vision stub's prefix and the encoder-decoder (over the audio stub's
    frames; without them it raises) are made and run
    (``tests/test_torch_mla.py`` and ``tests/test_torch_whisper.py`` hold
    them to the reference)."""
    assert item == "queue 1 item 13"
    cfg = dataclasses.replace(CFG, **change)
    if cfg.enc_dec:
        with pytest.raises(NotImplementedError, match="not ported"):
            M.check_supported(dataclasses.replace(cfg, frontend="none"))
    if cfg.attention == "mla":
        cfg = dataclasses.replace(cfg, q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8,
                                  v_head_dim=16, n_kv_heads=cfg.n_heads)
    if cfg.frontend == "vision_stub":
        cfg = dataclasses.replace(cfg, n_prefix_embeds=3)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe_d_ff=32)
    params = M.init_params(cfg, PLAN, seed=1, device="cpu", max_seq=16)
    if not cfg.enc_dec:       # param_count counts no decoder positions
        assert sum(p.numel() for p in params.parameters()) == \
            cfg.param_count()
    layer = params.layers[0]
    if cfg.attention == "mla":
        assert set(layer["attn"]) == {"w_dq", "w_uq", "w_dkv", "w_ukv", "wo",
                                      "q_ln", "kv_ln"}
    if cfg.n_shared_experts:
        assert layer["moe"]["shared"]["w_up"].shape == (cfg.d_model,
                                                        cfg.moe_d_ff)
    toks = torch.arange(1, 8)[None]
    batch = {"tokens": toks}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = torch.ones((1, 3, cfg.d_model))
    if cfg.enc_dec:
        assert {"ln_x", "xattn"} <= set(layer.keys())
        batch["enc_frames"] = torch.ones((1, 8, cfg.d_model))
    logits, _, caches = M.forward(params, cfg, PLAN, batch,
                                  collect_cache=True)
    assert logits.shape == (1, 7, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    if cfg.frontend == "vision_stub":        # the prefix is live input
        bare, _, _ = M.forward(params, cfg, PLAN, {"tokens": toks})
        assert not torch.equal(bare[:, :3], logits[:, :3])
    if cfg.enc_dec:                          # the frames are live input
        other, _, _ = M.forward(params, cfg, PLAN, {
            "tokens": toks, "enc_frames": torch.zeros((1, 8, cfg.d_model))})
        assert not torch.equal(other, logits)
    if cfg.attention == "mla":               # latent and rope key caches
        assert [tuple(c.shape) for c in caches[0]] == [
            (cfg.n_layers, 1, 7, 16), (cfg.n_layers, 1, 7, 8)]


# ---------------------------------------------------------------------------
# (c) page state
# ---------------------------------------------------------------------------

def jplanes(st) -> dict:
    return {name: np.asarray(getattr(st, name)) for name in kvc.PLANES}


def assert_pages_equal(port_state, ref_state, what: str) -> None:
    got, want = interop.page_state_to_numpy(port_state), jplanes(ref_state)
    for name in kvc.PLANES:
        assert got[name].dtype == want[name].dtype, (what, name)
        np.testing.assert_array_equal(got[name], want[name],
                                      err_msg=f"{what}: {name}")


def test_page_state_ops_match_the_reference_exhaustion_included():
    cfg = kvc.PagedKVConfig(n_pages=16, page_size=4, max_pages_per_seq=6,
                            max_seqs=3)
    jcfg = jkvc.PagedKVConfig(**dataclasses.asdict(cfg))
    js, ts = jkvc.init_page_state(jcfg), kvc.init_page_state(cfg, "cpu")
    assert_pages_equal(ts, js, "init")
    for op in (("alloc", 0, 3), ("alloc", 1, 5), ("alloc", 2, 9),  # row full
               ("alloc", 1, 1), ("len", 0, 11), ("slide", 0, 9),
               ("evict", 1), ("alloc", 2, 6), ("alloc", 0, 5),
               ("alloc", 1, 5),                                    # pool dry
               ("len", 2, 22), ("slide", 2, 22), ("alloc", 1, 4),
               ("evict", 0), ("evict", 2), ("evict", 2)):
        if op[0] == "alloc":
            js, jok = jkvc.allocate(jcfg, js, jnp.int32(op[1]), op[2])
            before = interop.page_state_to_numpy(ts)
            ts, ok = kvc.allocate(cfg, ts, op[1], op[2])
            assert ok == bool(jok), op
            if not ok:                      # unchanged, plane for plane
                after = interop.page_state_to_numpy(ts)
                assert all((before[n] == after[n]).all() for n in before)
        elif op[0] == "len":
            js = dataclasses.replace(js, lengths=js.lengths.at[op[1]].set(
                op[2]))
            ts.lengths[op[1]] = op[2]
        elif op[0] == "slide":
            js = jkvc.slide_window(jcfg, js, jnp.int32(op[1]),
                                   jnp.int32(op[2]))
            ts = kvc.slide_window(cfg, ts, op[1], torch.tensor(op[2]))
        else:
            js = jkvc.evict_seq(jcfg, js, jnp.int32(op[1]))
            ts = kvc.evict_seq(cfg, ts, op[1])
        assert_pages_equal(ts, js, str(op))
        if op == ("evict", 1):          # go on from the reference's state
            ts = interop.page_state_from_numpy(jplanes(js), device="cpu")
    for length, add in ((0, 1), (15, 1), (16, 1), (17, 8), (3, 0)):
        assert kvc.pages_needed(length, add, 4) == int(
            jkvc.pages_needed(jnp.int32(length), add, 4))


# ---------------------------------------------------------------------------
# (d) the slice as a whole: the engine against the reference's
# ---------------------------------------------------------------------------

ENGINE = dict(page_size=8, n_pages=24, max_seqs=3, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def served(tree, port_params):
    """Both engines through one traffic; per operation, what each gives."""
    rng = np.random.default_rng(6)
    jeng = JEngine(JCFG, JPLAN, jtree(tree), attn_impl="pallas_interpret",
                   **ENGINE)
    teng = PagedLMEngine(CFG, PLAN, port_params, device="cpu", **ENGINE)
    jlogits = []
    jdecode = jeng._decode

    def capture(*args):                 # the reference step's logits
        out = jdecode(*args)
        jlogits.append(out[0])
        return out

    jeng._decode = capture
    log = []

    def record(op, jout=None, tout=None):
        log.append(dict(op=op, jpages=jplanes(jeng.pages),
                        tpages=interop.page_state_to_numpy(teng.pages),
                        jout=jout, tout=tout,
                        jlast=np.asarray(jeng.last_tokens).copy(),
                        tlast=teng.last_tokens.numpy().copy()))

    def step(forced: bool):
        if forced:
            for seq in np.nonzero(np.asarray(jeng.pages.active))[0]:
                tok = int(rng.integers(1, CFG.vocab_size))
                jeng.last_tokens = jeng.last_tokens.at[seq, 0].set(tok)
                teng.last_tokens[seq, 0] = tok
        jn, tn = jeng.step(), teng.step()
        record("step", (np.asarray(jlogits[-1]), jn),
               (teng.logits.numpy().copy(), tn))

    fkernel.launches = pkernel.launches = 0
    for seq, n in ((0, 13), (1, 21)):           # not page multiples
        prompt = rng.integers(1, CFG.vocab_size, n)
        record(f"admit{seq}", jeng.admit(seq, prompt),
               teng.admit(seq, prompt))
    for _ in range(5):
        step(forced=True)
    jeng.slide(0, keep_last=8)
    teng.slide(0, keep_last=8)
    record("slide")
    jeng.evict(1)
    teng.evict(1)
    record("evict")
    prompt = rng.integers(1, CFG.vocab_size, 13)   # onto the freed pages
    record("readmit1", jeng.admit(1, prompt), teng.admit(1, prompt))
    for _ in range(3):
        step(forced=False)
    return log


def test_engine_page_state_matches_after_each_operation(served):
    assert [e["op"] for e in served] == ["admit0", "admit1"] + \
        ["step"] * 5 + ["slide", "evict", "readmit1"] + ["step"] * 3
    for i, e in enumerate(served):
        for name in kvc.PLANES:
            np.testing.assert_array_equal(e["tpages"][name],
                                          e["jpages"][name],
                                          err_msg=f"{i} {e['op']}: {name}")
    free = [int(e["tpages"]["free_top"]) for e in served]
    assert free[7] > free[6] and free[8] > free[7]   # slide, evict freed


def test_engine_logits_match_at_every_step(served):
    steps = [e for e in served if e["op"] == "step"]
    assert len(steps) == 8
    for i, e in enumerate(steps):
        (jl, jn), (tl, tn) = e["jout"], e["tout"]
        assert tl.shape == jl.shape == (ENGINE["max_seqs"], 1,
                                        CFG.vocab_size)
        np.testing.assert_allclose(tl, jl, rtol=ENGINE_TOL, atol=ENGINE_TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_array_equal(tn, jn, err_msg=f"step {i}")


def test_engine_admits_and_feeds_the_same_tokens(served):
    for e in served:
        np.testing.assert_array_equal(e["tlast"], e["jlast"],
                                      err_msg=e["op"])
        if e["op"].startswith(("admit", "readmit")):
            assert e["jout"] is True and e["tout"] is True
    assert fkernel.launches == 0 and pkernel.launches == 0   # CPU: plain


def test_engine_ref_impl_matches_the_default_on_the_cpu(port_params):
    """``attn_impl="ref"`` names the plain versions; on the CPU the default
    takes them too, so both engines give the same logits."""
    rng = np.random.default_rng(8)
    engines = [PagedLMEngine(CFG, PLAN, port_params, device="cpu",
                             attn_impl=impl, **ENGINE)
               for impl in ("kernel", "ref")]
    prompt = rng.integers(1, CFG.vocab_size, 11)
    for eng in engines:
        assert eng.admit(2, prompt)
        eng.step()
    assert torch.equal(engines[0].logits, engines[1].logits)
    with pytest.raises(ValueError, match="impl"):
        PagedLMEngine(CFG, PLAN, port_params, device="cpu",
                      attn_impl="pallas")


def test_engine_refuses_exhaustion_and_params_elsewhere(port_params):
    eng = PagedLMEngine(CFG, PLAN, port_params, device="cpu", page_size=4,
                        n_pages=3, max_seqs=2, max_pages_per_seq=4)
    assert not eng.admit(0, np.arange(1, 13))     # 13 slots > 3 pages
    assert int(eng.pages.free_top) == 3
    assert eng.admit(0, np.arange(1, 11))          # 3 pages, 12 slots
    eng.step()
    eng.step()                                     # slot 11: still fits
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.step()
    with pytest.raises(ValueError, match="params lie on"):
        PagedLMEngine(CFG, PLAN, port_params, device="meta")
